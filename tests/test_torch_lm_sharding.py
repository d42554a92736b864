"""The port's LM sharding specs and placement, held to the JAX package.

Every spec function of ``repro_torch`` (``param_specs`` /
``model_param_specs``, the three trees of ``train_state_specs``,
``arch_profile``, ``rules_for``, ``_shrink``, ``batch_spec_tree``,
``cache_spec_tree``, ``logits_spec``) equals the reference's entry for
entry, for the 10 archs, full and smoke configs, on duck-typed meshes of
shape (1, 1), (2, 2), (4, 1), (1, 4) and the 512-card (pod, data, model)
mesh: the spec functions of both packages read only ``mesh.axis_names`` and
``mesh.devices.shape``, so no device is needed. Each port entry is compared
through ``jax.sharding.PartitionSpec(*port_spec) == ref_spec``.
``CellSpec.args()`` (meta tensors) matches the reference's
``ShapeDtypeStruct`` trees on every runnable cell. Placement
(``distributed/sharding.py``), the compression functions and the mesh
builders are checked on the CPU with logical shards.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import all_cells as ref_all_cells  # noqa: E402
from repro.configs import arch_families as ref_arch_families  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import ctx as ref_ctx  # noqa: E402
from repro.distributed import lm_sharding as ref_lms  # noqa: E402
from repro.launch.specs import CellSpec as RefCellSpec  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import params as ref_params  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import ctx, lm_sharding  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum_mean,
    dequantize_int8,
    ef_update,
    quantize_int8,
)
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NamedSharding,
    P,
    PartitionSpec,
    ShardedTensor,
    gather_tree,
    named_tree,
    place,
    place_tree,
)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import CellSpec, batch_struct, input_specs  # noqa: E402
from repro_torch.models.model import cache_zeros, model_param_specs, model_schema  # noqa: E402
from repro_torch.models.params import param_specs, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
META = torch.device("meta")


class DuckMesh:
    """What both packages' spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = tuple(names)


MESHES = {
    "1x1": DuckMesh((1, 1), ("data", "model")),
    "2x2": DuckMesh((2, 2), ("data", "model")),
    "4x1": DuckMesh((4, 1), ("data", "model")),
    "1x4": DuckMesh((1, 4), ("data", "model")),
    "pod2x16x16": DuckMesh((2, 16, 16), ("pod", "data", "model")),
}
CONFIGS = [(a, s) for a in ARCHS for s in ("full", "smoke")]


def _cfgs(arch, size):
    if size == "smoke":
        return get_smoke_config(arch), ref_get_smoke(arch)
    return get_config(arch), ref_get_config(arch)


def _flat(tree, prefix=""):
    """[(path, leaf)] of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _ref_flat(tree):
    """The reference's tree as [(path, leaf)], PartitionSpecs as leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("".join(f"/{k.key}" for k in path), leaf) for path, leaf in leaves]


def _assert_specs_equal(port, ref):
    got, want = _flat(port), _ref_flat(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert isinstance(a, PartitionSpec), (path, a)
        assert JP(*a) == b, (path, a, b)
        assert a == tuple(b), (path, a, b)


# ------------------------------------------------------------ spec functions


@pytest.mark.parametrize("arch,size", CONFIGS)
def test_param_specs_match_reference(arch, size):
    cfg, rcfg = _cfgs(arch, size)
    _assert_specs_equal(model_param_specs(cfg), ref_model.model_param_specs(rcfg))
    table = {"fsdp": None, "tp": "model", "vocab": ("model",), None: None}
    _assert_specs_equal(param_specs(model_schema(cfg), table),
                        ref_params.param_specs(ref_model.model_schema(rcfg), table))


@pytest.mark.parametrize("arch,size", CONFIGS)
@pytest.mark.parametrize("zero3", [True, False])
def test_train_state_specs_match_reference(arch, size, zero3):
    """All three trees, on the three branches (tp with zero3 true or false,
    and dp, whose zero3 flag changes nothing)."""
    cfg, rcfg = _cfgs(arch, size)
    cfg, rcfg = cfg.scaled(zero3=zero3), rcfg.scaled(zero3=zero3)
    assert ctx.arch_profile(cfg) == ref_ctx.arch_profile(rcfg)
    for port, ref in zip(lm_sharding.train_state_specs(cfg), ref_lms.train_state_specs(rcfg),
                         strict=True):
        _assert_specs_equal(port, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_profile_rules_and_batch_specs_match_reference(arch, size, mesh):
    cfg, rcfg = _cfgs(arch, size)
    m = MESHES[mesh]
    assert ctx.arch_profile(cfg) == ref_ctx.arch_profile(rcfg)
    assert ctx.rules_for(cfg, m) == ref_ctx.rules_for(rcfg, m)
    assert lm_sharding.dp_axes(m) == ref_lms.dp_axes(m)
    assert lm_sharding.dp_size(m) == ref_lms.dp_size(m)
    for b in (1, 3, 8, 256):
        shape = SHAPES["train_4k"].__class__("t", "train", 64, b)
        batch = batch_struct(cfg, shape, with_labels=True)
        ref_batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32) for k, v in batch.items()}
        _assert_specs_equal(lm_sharding.batch_spec_tree(cfg, m, batch),
                            ref_lms.batch_spec_tree(rcfg, m, ref_batch))
        got = lm_sharding.logits_spec(cfg, m, b)
        assert JP(*got) == ref_lms.logits_spec(rcfg, m, b)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,size", CONFIGS)
def test_cache_specs_match_reference(arch, size, mesh):
    """``cache_zeros`` on the meta device against ``jax.eval_shape(init_cache)``
    (shapes and dtypes), then ``cache_spec_tree`` on both."""
    cfg, rcfg = _cfgs(arch, size)
    m = MESHES[mesh]
    shapes = ((4, 64), (1, 32)) if size == "smoke" else ((128, 32768), (1, 524288))
    for batch, seq in shapes:
        cache = cache_zeros(cfg, batch, seq, META)
        ref = jax.eval_shape(lambda: ref_model.init_cache(rcfg, batch, seq))
        got, want = _flat(cache), _ref_flat(ref)
        assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in got] == \
               [(p, tuple(t.shape), np.dtype(t.dtype).name) for p, t in want]
        assert all(t.device == META for _, t in got)
        if cache:
            _assert_specs_equal(lm_sharding.cache_spec_tree(cfg, m, cache),
                                ref_lms.cache_spec_tree(rcfg, m, ref))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shrink_and_resolved_constraints_match_reference(mesh):
    m = MESHES[mesh]
    axes = [None, "data", "model", "pod", ("data",), ("data", "model"),
            ("pod", "data"), ("pod", "data", "model")]
    for axis in axes:
        for dim in (1, 2, 3, 4, 6, 8, 16, 32, 64, 512, 1024):
            assert ctx._axis_size(m, axis) == ref_ctx._axis_size(m, axis)
            assert ctx._shrink(m, axis, dim) == ref_ctx._shrink(m, axis, dim), (axis, dim)
    for arch in ("qwen1.5-110b", "smollm-135m", "minicpm3-4b", "mamba2-780m"):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        rules = ref_ctx.rules_for(rcfg, m)
        x = torch.zeros((8, 32, 16, 4))
        assert ctx.resolve_constraint(x.shape, "dp", "sp", "tp", None) is None
        with ctx.activation_scope(cfg, m):
            for names in (("dp", "sp", "tp", None), ("dp", None, None, "tp"),
                          (None, "dp", "tp", "sp")):
                got = ctx.resolve_constraint(x.shape, *names)
                want = JP(*[ref_ctx._shrink(m, rules.get(n) if n else None, d)
                            for d, n in zip(x.shape, names)])
                assert JP(*got) == want, (arch, names)
                assert ctx.constrain(x, *names) is x
            with pytest.raises(AssertionError):
                ctx.constrain(x, "dp", "tp")
        assert ctx.resolve_constraint(x.shape, "dp", "sp", "tp", None) is None


# ------------------------------------------------------------------ cells


def _cells():
    return [(a, s) for a, s, runs, _ in ref_all_cells(ref_arch_families()) if runs]


def test_runnable_cells_are_31():
    assert len(_cells()) == 31


@pytest.mark.parametrize("arch,shape", _cells())
def test_cellspec_args_match_reference(arch, shape):
    """Structure, shapes and dtypes of every positional arg, meta tensors
    against the reference's ``ShapeDtypeStruct``s; nothing allocated."""
    spec = CellSpec(arch, shape)
    assert spec.runs
    args = spec.args()
    ref = RefCellSpec(arch, shape).args()
    assert len(args) == len(ref)
    for a, r in zip(args, ref):
        if isinstance(a, dict):
            got, want = _flat(a), _ref_flat(r)
        else:
            got, want = [("", a)], [("", r)]
        assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in got] == \
               [(p, tuple(t.shape), np.dtype(t.dtype).name) for p, t in want]
        assert all(t.device == META for _, t in got)
    assert [tuple(t.shape) for t in tree_leaves(input_specs(arch, shape)[0])] == \
           [tuple(t.shape) for t in tree_leaves(args[0])]


# -------------------------------------------------------------- placement


def test_partition_spec_equality_normalises_as_jax():
    cases = [(("data",), "data"), ((), None), (("data", "model"), ("data", "model")),
             ("data", "model"), (None, "data")]
    for a, b in cases:
        assert (P(a) == P(b)) == (JP(a) == JP(b)), (a, b)
        assert (hash(P(a)) == hash(P(b))) or P(a) != P(b)
    assert P(None, ("data",), "model") == P(None, "data", "model")
    assert P("data") != P("data", None)
    assert (P("data") != P(("data",))) is False
    assert P("data") == ("data",) and JP(*P(("pod", "data"))) == JP(("pod", "data"))
    assert repr(P(None, ("data", "model"))) == "P(None, ('data', 'model'))"


def _logical(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


SPECS = [P(), P("data"), P(None, "model"), P(("data", "model")), P("model", "data"),
         P(None, ("model", "data")), P(("data",), None)]


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_place_round_trip_and_blocks(shape, spec):
    mesh = _logical(shape)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 12)).astype(np.float32))
    sh = NamedSharding(mesh, spec)
    st = place(x, sh, "w")
    assert isinstance(st, ShardedTensor) and st.shape == x.shape and st.dtype == x.dtype
    assert torch.equal(st.full(CPU), x)
    sizes = dict(zip(mesh.axis_names, shape))
    per_dim = [int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e or ())]))
               for e in list(spec) + [None] * (2 - len(spec))]
    assert len(st.blocks) == int(np.prod(per_dim))  # one tensor per distinct block
    for pos in np.ndindex(*shape):
        at = dict(zip(mesh.axis_names, pos))
        sl = []
        for d, e in enumerate(list(spec) + [None] * (2 - len(spec))):
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            i = 0
            for a in axes:
                i = i * sizes[a] + at[a]
            step = x.shape[d] // per_dim[d]
            sl.append(slice(i * step, (i + 1) * step))
        assert torch.equal(st.block(pos), x[tuple(sl)]), (pos, spec)
    nbytes = x.numel() * 4 * len(st.blocks) // int(np.prod(per_dim))
    assert st.nbytes == nbytes


def test_replicated_leaf_is_one_tensor_a_device():
    mesh = _logical((2, 2))
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    st = place(x, NamedSharding(mesh, P()))
    assert len(st.blocks) == 1
    assert all(st.block(pos) is st.block((0, 0)) for pos in np.ndindex(2, 2))
    assert st.block((0, 0)) is x  # already on its device: not copied
    assert st.full(CPU) is x
    half = place(x, NamedSharding(mesh, P("data")))
    assert len(half.blocks) == 2 and half.block((0, 1)) is half.block((0, 0))
    assert half.block((1, 0)).untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def test_place_refuses_uneven_specs():
    mesh = _logical((2, 2))
    with pytest.raises(ValueError, match=r"leaf layers/wq: dim 1 .*\('model',\) of size 2"):
        place(torch.zeros(4, 3), NamedSharding(mesh, P(None, "model")), "layers/wq")
    with pytest.raises(ValueError, match="size 4"):
        place(np.zeros((6, 4), np.float32), NamedSharding(mesh, P(("data", "model"))), "x")
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh, P("pod"))
    with pytest.raises(ValueError, match="twice"):
        NamedSharding(mesh, P("data", "data"))


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b", "mamba2-780m"])
def test_place_tree_of_train_state_round_trips(arch):
    """The smoke state placed by ``train_state_specs`` on a 2 x 2 mesh of
    logical shards gathers back bit for bit, bf16 included."""
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw_init

    cfg = get_smoke_config(arch)
    mesh = _logical((2, 2))
    pspecs, ospecs, _ = lm_sharding.train_state_specs(cfg)
    params = init_model(0, cfg, "cpu")
    opt = adamw_init(params)
    pp = place_tree(params, named_tree(mesh, pspecs))
    po = place_tree(opt, named_tree(mesh, ospecs))
    for a, b in zip(tree_leaves(params), tree_leaves(gather_tree(pp, CPU))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(opt), tree_leaves(gather_tree(po, CPU))):
        assert torch.equal(a, b)
    held = sum(t.nbytes for t in tree_leaves(pp))
    dense = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert held == dense  # every block once on one device, replicated leaves included


# ------------------------------------------------------------ mesh builders


def test_host_and_production_meshes():
    m = make_host_mesh(2, 2, devices=[CPU] * 4)
    assert m.axis_names == ("data", "model") and m.devices.shape == (2, 2)
    p = make_production_mesh(devices=[CPU] * 256)
    assert p.axis_names == ("data", "model") and p.devices.shape == (16, 16)
    pm = make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert pm.axis_names == ("pod", "data", "model") and pm.devices.shape == (2, 16, 16)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < 256:
        with pytest.raises(RuntimeError, match="needs 256 CUDA devices"):
            make_production_mesh()
    if have < 4:
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            make_host_mesh(2, 2)


# ------------------------------------------------------------ compression


def _ref(fn, *xs):
    return [np.asarray(o) for o in fn(*[jnp.asarray(x) for x in xs])]


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_ef_update_bit_equal_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((33, 65)) * 10 ** rng.uniform(-6, 3)).astype(np.float32)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]  # halves: both round to even
    q, s = quantize_int8(torch.from_numpy(x))
    rq, rs = _ref(ref_comp.quantize_int8, x)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), rq)
    assert s.numpy().tobytes() == rs.tobytes()
    d = dequantize_int8(q, s)
    assert d.numpy().tobytes() == np.asarray(ref_comp.dequantize_int8(jnp.asarray(rq),
                                                                      jnp.asarray(rs))).tobytes()
    r = (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)
    got = ef_update(torch.from_numpy(x), torch.from_numpy(r))
    want = _ref(ref_comp.ef_update, x, r)
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.tobytes()
    zq, zs = quantize_int8(torch.zeros(4, 4))
    assert not zq.any() and float(zs) == np.float32(1e-12) / np.float32(127.0)


def _emulated_mean(stacked: np.ndarray) -> np.ndarray:
    """The compressed mean in NumPy: shared amax, int8 against the shared
    scale (half to even), an exact int32 sum, dequantize, divide by n."""
    xs = stacked.astype(np.float32)
    amax = np.max(np.abs(xs))
    scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127.0)
    q = np.clip(np.round(xs / scale), -127, 127).astype(np.int8)
    total = q.astype(np.int32).sum(axis=0, dtype=np.int32)
    return (total.astype(np.float32) * scale / np.float32(len(xs))).astype(np.float32)


@pytest.mark.parametrize("placed", [False, True])
def test_compressed_psum_mean_against_emulation_and_exact(placed):
    """The reference's case (8 'pod' shards of [8, 64]): bit-equal to the
    NumPy emulation, within 0.02 of the exact mean
    (tests/test_distributed.py's bound), every entry the same."""
    mesh = make_mesh((8,), ("pod",), devices=[CPU] * 8)
    rng = np.random.default_rng(0)
    g = rng.normal(size=(8, 64)).astype(np.float32)
    w = torch.from_numpy(g.copy())
    if placed:
        w = place(w, NamedSharding(mesh, P("pod", None)))
    out = compressed_psum_mean({"w": w}, mesh, "pod")["w"]
    got = out.full(CPU) if placed else out
    assert isinstance(out, ShardedTensor) == placed and got.shape == (8, 64)
    want = _emulated_mean(g)
    for i in range(8):
        assert got[i].numpy().tobytes() == want.tobytes()
    exact = g.mean(axis=0)
    err = np.abs(got[0].numpy() - exact).max() / (np.abs(exact).max() + 1e-9)
    assert err < 0.02, err


def test_error_feedback_residual_stays_within_one_step():
    """Over 20 steps the sum of (decoded - true) telescopes to minus the
    last residual, which stays within one quantisation step (half a scale
    per element)."""
    rng = np.random.default_rng(3)
    residual = torch.zeros(256)
    err_sum = torch.zeros(256)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        q, scale, residual = ef_update(g, residual)
        err_sum += dequantize_int8(q, scale) - g
        assert float(residual.abs().max()) <= float(scale) * 0.5 * (1 + 1e-6)
        assert torch.allclose(err_sum, -residual, atol=1e-5)
