#!/usr/bin/env python3
"""How far bf16 serving on a mesh lands from one device, path by path.

    PYTHONPATH=src python3 tools/tp_drift.py [--layers 8]

deepseek-67b at full width, cut to ``--layers`` of 95, bf16, attention
"flash", on logical shards of one card: 4 x 512 prompt tokens and 16 steps
(chip_smoke's phase 21d shape) teacher-forced on the one-device session's
tokens, for

  * the tensor-parallel path on 2 x 2, 1 x 2 and 2 x 1 (on 2 x 1 the model
    axis splits nothing: only the data split and the path's float32
    reductions differ from one device);
  * the gathered path on 2 x 2 (every parameter gathered whole, as the
    other families serve; ``serves_tensor_parallel`` patched off).

Each prints the logits' relative norm against the one-device session and
against a float32 run of the same weights (the max over the steps), the
prefill's and the largest decode step's. The bf16 runs' distance from
float32 sets the scale: two bf16 runs whose roundings part anywhere land
about that far apart. Needs one NVIDIA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek-67b"
PATHS = (("tensor-parallel", (2, 2)), ("tensor-parallel", (1, 2)), ("tensor-parallel", (2, 1)),
         ("gathered", (2, 2)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_drift: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    smoke.phase_device()
    smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH).scaled(n_layers=args.layers)
    b, plen, gen = smoke.FAMILY_BATCH, smoke.FAMILY_PROMPT, smoke.FAMILY_GEN
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    prompts = np.random.default_rng(23).integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    common = dict(batch=b, max_seq=plen + gen, attention_impl="flash", n_layers=args.layers)
    tokens, stats = ServeSession(ARCH, params=params, **common).generate(prompts, gen,
                                                                        keep_logits=True)
    forced = tokens[:, plen:]
    f32 = ServeSession(ARCH, params=tree_map(lambda t: t.float(), params), dtype="float32",
                       **common)
    exact = smoke._forced(f32, prompts, None, forced)[0]
    del f32
    torch.cuda.empty_cache()
    one_f32 = smoke._step_rels(torch.as_tensor(stats["logits"]), exact, cfg.vocab)
    print(f"[tp drift] {ARCH}, {args.layers} layers, bf16, {b} x {plen} + {gen}; one device "
          f"against float32: prefill {one_f32[0]:.6f}, decode max {max(one_f32[1:]):.6f}; "
          f"{smoke.nvidia_smi_line()}", flush=True)
    real = steps.serves_tensor_parallel
    for path, shape in PATHS:
        if path == "gathered":
            steps.serves_tensor_parallel = lambda cfg, mesh: False
        try:
            sess = ServeSession(ARCH, mesh=smoke._logical_mesh(shape), params=params, **common)
            got = smoke._forced(sess, prompts, None, forced)[0]
        finally:
            steps.serves_tensor_parallel = real
        del sess
        torch.cuda.empty_cache()
        rels = smoke._step_rels(got, stats["logits"], cfg.vocab)
        to_f32 = smoke._step_rels(got, exact, cfg.vocab)
        print(f"[tp drift] {path} on {shape}: against one device prefill {rels[0]:.6f}, decode "
              f"max {max(rels[1:]):.6f}; against float32 prefill {to_f32[0]:.6f}, decode max "
              f"{max(to_f32[1:]):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
