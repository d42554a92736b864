"""The flash kernel's launch path on the CPU: the strides it derives by
arithmetic on the shape, its checks (once a call, refusing what they
refused before), and its cost report (nothing outside a counter). The
launch itself runs only on a card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="hypothesis not installed; skipping property tests")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SHAPES = st.lists(st.integers(0, 5), min_size=1, max_size=4)


@settings(max_examples=200, deadline=None)
@given(SHAPES)
def test_dense_strides_equal_torch_contiguous_strides(shape):
    """The contiguous layout's strides by arithmetic, as a meta tensor gives
    them, size-0 and size-1 dimensions included."""
    assert fa._dense_strides(shape) == list(torch.empty(shape, device="meta").stride())


@settings(max_examples=200, deadline=None)
@given(SHAPES, st.randoms(use_true_random=False))
def test_strides_take_the_dense_stride_at_size_one_dims(shape, rnd):
    """``_strides``: a tensor's own stride where a dimension has more than one
    element, the contiguous layout's where it has one, on permuted
    (non-contiguous) views too."""
    order = list(range(len(shape)))
    rnd.shuffle(order)
    base = torch.empty([shape[d] for d in order], device="meta")
    t = base.permute([order.index(d) for d in range(len(shape))])
    assert tuple(t.shape) == tuple(shape)
    dims = tuple(range(len(shape)))
    dense = torch.empty(shape, device="meta").stride()
    want = [dense[d] if shape[d] == 1 else t.stride(d) for d in dims]
    assert fa._strides(t, dims) == want


def _ops(hd=80, b=2, sq=8, sk=8, h=4, kh=2, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(hd)
    q = torch.randn(b, sq, h, hd, generator=gen).to(dtype)
    k = torch.randn(b, sk, kh, hd, generator=gen).to(dtype)
    v = torch.randn(b, sk, kh, hd, generator=gen).to(dtype)
    qp = torch.arange(sq, dtype=torch.int32)[None].expand(b, sq).contiguous()
    kp = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk).contiguous()
    return q, k, v, qp, kp


@pytest.fixture
def shape_checks(monkeypatch):
    """Counts the calls of the shape checker (all three entries use it)."""
    calls = []
    real = fa._check_bshd_shapes

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fa, "_check_bshd_shapes", counted)
    return calls


def test_shape_checks_run_once_on_the_cpu_path(shape_checks):
    fa.flash_attention_bshd(*_ops())
    assert len(shape_checks) == 1


def test_shape_checks_run_once_in_the_kernel_wrapper(shape_checks):
    with pytest.raises(ValueError, match="CUDA tensor"):  # every check up to the device passed
        fa.flash_attention_bshd_cuda(*_ops())
    assert len(shape_checks) == 1


def test_shape_checks_run_once_on_the_card_path(shape_checks, monkeypatch):
    """The model's entry on the card checks the shapes once, not again in
    ``flash_attention_bshd_cuda``: its launch is stubbed and the operands
    pass for CUDA tensors."""
    launched = []

    def launch(q, k, v, q_pos, k_pos, causal, tiles, qkv_strides):
        launched.append(qkv_strides)
        return torch.empty(q.shape, dtype=q.dtype)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(fa, "_launch", launch)
    q, k, v, qp, kp = _ops(b=2, sq=8, sk=8, h=4, kh=2, hd=80)
    fa.flash_attention_bshd(q, k, v, qp, kp)
    assert len(shape_checks) == 1
    # q's (batch, row, head) strides, then k's and v's
    assert launched == [[8 * 4 * 80, 4 * 80, 80, 8 * 2 * 80, 2 * 80, 80, 8 * 2 * 80, 2 * 80, 80]]


BAD = {
    "head dim": (dict(hd=48), ValueError, "head dim"),
    "value width": ("mla", ValueError, "equal query, key and value head dims"),
    "kv heads": (dict(h=3, kh=2), ValueError, "multiple of the KV heads"),
    "k and v": ("short_v", ValueError, "k and v"),
    "positions": ("short_qp", ValueError, "positions"),
    "position dtype": ("long_kp", TypeError, "int32"),
    "half": (dict(dtype=torch.float16), TypeError, "bfloat16 or all float32"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_cpu_path_refuses_what_the_card_refuses(case):
    """The CPU path raises the card's errors on shapes and types the kernel
    lacks, as before the launch path was made lean; so does the kernel
    wrapper on the same CPU tensors, before it refuses their device."""
    how, exc, match = BAD[case]
    ops = list(_ops(**how) if isinstance(how, dict) else _ops())
    if how == "mla":
        ops[2] = ops[2][..., :64].contiguous()
    elif how == "short_v":
        ops[2] = ops[2][:, :4].contiguous()
    elif how == "short_qp":
        ops[3] = ops[3][:, :3].contiguous()
    elif how == "long_kp":
        ops[4] = ops[4].long()
    for entry in (fa.flash_attention_bshd, fa.flash_attention_bshd_cuda):
        with pytest.raises(exc, match=match):
            entry(*ops)


def test_report_costs_nothing_outside_a_counter(monkeypatch):
    """Outside a cost counter ``_report`` neither computes the launch's cost
    nor reports it; inside one it reports ``flash_launch_cost`` once."""
    def no_cost(*args):
        raise AssertionError("flash_launch_cost computed with no counter active")

    reported = []
    monkeypatch.setattr(fa, "flash_launch_cost", no_cost)
    monkeypatch.setattr(fa, "report_cost", lambda *a, **kw: reported.append(a))
    q, k, *_ = _ops()
    assert not common.COST_SINKS
    fa._report(q, k, True)
    meta = [t.to("meta") for t in _ops()]
    out = fa.flash_attention_bshd(*meta)  # the meta stand-in for a launch
    assert out.is_meta and tuple(out.shape) == tuple(meta[0].shape)
    assert reported == []
    monkeypatch.undo()

    sink = []
    common.COST_SINKS.append(lambda flops, nbytes, matmul: sink.append((flops, nbytes, matmul)))
    try:
        fa._report(q, k, False)
    finally:
        common.COST_SINKS.pop()
    b, sq, h, hd = q.shape
    assert sink == [(*fa.flash_launch_cost(b, h, k.shape[2], sq, k.shape[1], hd, 2, False), True)]
