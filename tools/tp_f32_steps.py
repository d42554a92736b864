#!/usr/bin/env python3
"""Where a float32 tensor-parallel decode step parts from one device's.

    PYTHONPATH=src python3 tools/tp_f32_steps.py [--arch ARCH[:LAYERS]] [--seed N] ...

Each ``--arch`` (an MLA config; default minicpm3-4b:2) at full width in
float32 as phase 21d's float32 run has it (``chip_smoke.SERVE_SHARD_F32_SHAPE``:
4 x 32 prompt tokens and 4 steps, the weights from seed 0),
tensor-parallel on 2 x 2 logical shards of one card: on the prompts 21d
draws for that run (its ``SERVE_TP_SEED`` generator replayed over the runs
before it, ``chip_smoke._tp_inputs``; where 21d has no such run, none) and
on those of each ``--seed`` (default 0 and 1), each with the query latent
norms as the init draws them and scaled as 21d scales them
(``chip_smoke._sharp_mla``). Each decode step starts from a copy of the
one-device session's cache, as 21d's float32 rule does, and prints:

  * the logits' relative norm against the one-device step, and each row's;
  * the cache entries the step writes at its position (bf16 whatever the
    dtype): how many elements the tensor-parallel step rounded to another
    bf16 value than one device did, by layer and leaf;
  * the same step with those entries replaced by one device's as they are
    written (``models/model.py::_write_token``): what is left once the
    bf16 roundings of the token's own entries agree.

The rows and the attention decide nothing here; the readings say whether a
step's distance comes from a bf16 rounding of the cache that the two paths'
float32 sums put on either side of a rounding boundary. Needs one NVIDIA
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _spec(text: str) -> tuple[str, int | None]:
    arch, _, layers = text.partition(":")
    return arch, int(layers) if layers else None


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _at(cache: dict, pos: int) -> dict:
    """The cache entries at sequence position ``pos``: {leaf: [L, B, ...]}."""
    from repro_torch.models.model import _batch_dim

    out = {}
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            continue  # the SSM's states: no sequence
        s = _batch_dim(name, leaf) + 1
        out[name] = leaf.select(s, pos)
    return out


def phase_prompts(smoke, arch: str, layers: int | None):
    """The prompts phase 21d draws for ``arch``'s float32 run at
    ``layers``, or None where it has no such run."""
    from repro_torch.configs import get_config

    rng = np.random.default_rng(smoke.SERVE_TP_SEED)
    for a, depth, dtype in smoke.SERVE_TP_RUNS:
        _, prompts, _ = smoke._tp_inputs(get_config(a).scaled(n_layers=depth, dtype=dtype),
                                         dtype, rng)
        if (a, depth, dtype) == (arch, layers, "float32"):
            return prompts
    return None


def steps(smoke, arch: str, layers: int | None, prompts, source: str, sharp: bool,
          device) -> None:
    """Print one (config, prompts, weights) case's readings (module
    docstring); ``prompts``: ``[B, P]`` tokens, or the seed that draws
    them."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    full = get_config(arch)
    if full.attention != "mla":
        raise SystemExit(f"tp_f32_steps: {arch} is not an MLA config")
    impl = smoke.SERVE_SHARD_IMPL.get(arch, "flash")
    cfg = full.scaled(n_layers=layers or full.n_layers, dtype="float32", attention_impl=impl)
    b, plen, gen = smoke.SERVE_SHARD_F32_SHAPE
    if isinstance(prompts, int):  # a seed
        prompts = np.random.default_rng(prompts).integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg, device)
    smoke._open_gates(params)
    smoke._passing_conv(params)
    if sharp:
        smoke._sharp_mla(params, cfg)
    common = dict(batch=b, max_seq=plen + gen, attention_impl=impl, n_layers=layers,
                  dtype="float32")
    one = ServeSession(arch, params=params, device=device, **common)
    tokens, _ = one.generate(prompts, gen)
    forced = tokens[:, plen:]
    runs = []  # (start cache, logits, end cache) of each one-device step
    with one.gathered():
        _, cache = one.prefill(prompts)
        for i in range(gen - 1):
            tok = torch.from_numpy(forced[:, i:i + 1].astype(np.int32)).to(device)
            start = tree_map(torch.clone, cache)
            logits, cache = one.decode(cache, tok, plen + i)
            runs.append((start, logits, tree_map(torch.clone, cache)))
    del one
    sess = ServeSession(arch, mesh=smoke._logical_mesh(smoke.SERVE_TP_MESH), params=params,
                        **common)
    del params
    weights = "q_norm scaled (_sharp_mla)" if sharp else "the init's weights"
    with sess.gathered():
        for i, (start, want, end) in enumerate(runs):
            pos = plen + i
            tok = torch.from_numpy(forced[:, i:i + 1].astype(np.int32)).to(device)
            got, placed = sess.decode(tree_map(torch.clone, start), tok, pos)
            mine, theirs = _at(gather_tree(placed, device), pos), _at(end, pos)
            parted = {k: [int((mine[k][li] != theirs[k][li]).sum()) for li in range(cfg.n_layers)]
                      for k in mine}
            real = model_mod._write_token

            def agreed(leaf, lead, lo, p, new, end=end):
                """One device's entry written in place of this step's
                (``ckv`` and ``krope`` differ in width)."""
                name = "ckv" if new.shape[-1] == cfg.kv_lora_rank else "krope"
                rows = _at(end, p)[name][lead][lo:lo + new.shape[0]]
                real(leaf, lead, lo, p, rows.unsqueeze(1).to(new.dtype))

            model_mod._write_token = agreed
            try:
                same, _ = sess.decode(tree_map(torch.clone, start), tok, pos)
            finally:
                model_mod._write_token = real
            v = cfg.vocab
            rows = [float(f"{_rel(got[r, :v], want[r, :v]):.3e}") for r in range(b)]
            total = {k: mine[k][0].numel() for k in mine}
            print(f"[tp f32] {arch} {cfg.n_layers} layers, {source} prompts, {weights}, step "
                  f"{i + 1} (position {pos}): against one device {_rel(got[:, :v], want[:, :v]):.3e}"
                  f" (rows {rows}); cache entries at the position rounded to another bf16 value, "
                  f"by layer: {', '.join(f'{k} {n} of {total[k]}' for k, n in parted.items())}; "
                  f"with one device's entries written: {_rel(same[:, :v], want[:, :v]):.3e}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=_spec, action="append",
                    help="ARCH[:LAYERS], repeatable (default minicpm3-4b:2)")
    ap.add_argument("--seed", type=int, action="append", help="prompts' seed (default 0 and 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_f32_steps: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    print(f"[tp f32] {smoke.nvidia_smi_line()}", flush=True)
    for arch, layers in args.arch or [("minicpm3-4b", 2)]:
        cases = [("phase 21d's", phase_prompts(smoke, arch, layers))]
        cases += [(f"seed {n}", n) for n in args.seed or [0, 1]]
        for source, prompts in cases:
            if prompts is None:
                continue
            for sharp in (False, True):
                steps(smoke, arch, layers, prompts, source, sharp, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
