#!/usr/bin/env python3
"""How far the audio encoder's bf16 training on a mesh lands from one device, path by path.

    PYTHONPATH=src python3 tools/train_drift.py [--lr LR] ...

hubert-xlarge at full width and phase 20's cut (``chip_smoke.SHARD_AUDIO_LAYERS``
of 48 layers, bf16, remat "full", attention "xla", 4 x 512 frames), on
logical shards of one card, on each path: one device, the gathered path on
2 x 2 (``trains_tensor_parallel`` patched off: every parameter gathered
whole) and the tensor-parallel train step on 2 x 2, 1 x 2 and 2 x 1 (on 2 x 1
the model axis splits nothing: only the data split and the float32
reductions differ from one device):

  * the gradients of one batch (phase 20's float32 gradient batch at 4 x
    512: ``SyntheticLMDataset``, seed 3), by ``loss_and_grads`` on one
    device and by ``sharded_loss_and_grads`` on the others, against
    ``loss_and_grads`` of the same weights in float32 and against one
    device's bf16 gradients: the loss and every leaf's relative L2 (the
    worst leaf and the median). A path whose bf16 gradients land no
    farther from float32 than one device's rounds as one device does;
  * for each ``--lr`` (repeatable; default 1e-3, the other phase 20 loops'
    peak, and ``chip_smoke.SHARD_AUDIO_LR``), ``chip_smoke.SHARD_TRAIN_STEPS``
    ``TrainLoop`` steps under ``chip_smoke.TRAIN_SCHEDULE`` (one device
    twice): each step's loss, its distance from the first one-device
    loop's, and the ms a step.

Phase 20's bf16 hubert loop reads its learning rate from these. Needs one
NVIDIA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PATHS = (("one device", None, True), ("one device again", None, True),
         ("gathered", (2, 2), False), ("tensor-parallel", (2, 2), True),
         ("tensor-parallel", (1, 2), True), ("tensor-parallel", (2, 1), True))


@contextlib.contextmanager
def _path(tp: bool):
    """The train step's path: tensor-parallel where ``trains_tensor_parallel``
    says so, else (``tp`` false) the gathered one."""
    from repro_torch.launch import steps

    real = steps.trains_tensor_parallel
    if not tp:
        steps.trains_tensor_parallel = lambda cfg, mesh: False
    try:
        yield
    finally:
        steps.trains_tensor_parallel = real


def grads(smoke, cfg) -> None:
    """Print each path's bf16 loss and gradients against float32 and one
    device (module docstring)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.lm_sharding import batch_spec_tree, named_tree, train_state_specs
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.steps import loss_and_grads, sharded_loss_and_grads
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves, tree_map

    b, s = smoke.SHARD_AUDIO_SHAPE
    params = init_model(0, cfg, smoke.SHARD_DEVICE)
    batch = {k: torch.from_numpy(v).to(smoke.SHARD_DEVICE) for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=3, family=cfg.family,
        d_frontend=cfg.d_frontend).batch(0).items()}
    f32_loss, _, f32 = loss_and_grads(tree_map(lambda t: t.float(), params), batch,
                                      cfg.scaled(dtype="float32"))
    f32 = tree_leaves(f32)
    one_loss, _, one = loss_and_grads(params, batch, cfg)
    one = tree_leaves(one)
    names = smoke._leaf_names(params)
    pspecs, _, gspecs = train_state_specs(cfg)

    def line(label: str, loss, got: list) -> None:
        to_f32 = [smoke._rel(g, w) for g, w in zip(got, f32)]
        to_one = [smoke._rel(g, w) for g, w in zip(got, one)]
        print(f"[train drift] {cfg.name} grads, {label}: loss {float(loss):.6f} (float32 "
              f"{float(f32_loss):.6f}, one device {float(one_loss):.6f}); relative L2 against "
              f"float32 worst {max(to_f32):.4e} ({names[int(np.argmax(to_f32))]}), median "
              f"{float(np.median(to_f32)):.4e}; against one device's bf16 worst "
              f"{max(to_one):.4e} ({names[int(np.argmax(to_one))]}), median "
              f"{float(np.median(to_one)):.4e}", flush=True)

    line("one device", one_loss, one)
    for label, shape, tp in PATHS[2:]:
        mesh = smoke._logical_mesh(shape)
        placed = place_tree(params, named_tree(mesh, pspecs))
        bp = place_tree(batch, named_tree(mesh, batch_spec_tree(cfg, mesh, batch)))
        with _path(tp):
            loss, _, got = sharded_loss_and_grads(placed, bp, cfg, named_tree(mesh, gspecs))
        line(f"{label} on {shape}", loss, [g.full() for g in tree_leaves(got)])
        del placed, got
        torch.cuda.empty_cache()


def loops(smoke, cfg, lr: float) -> None:
    """Print each path's TrainLoop losses at peak ``lr`` (module docstring)."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig

    b, s = smoke.SHARD_AUDIO_SHAPE
    first = None
    for label, shape, tp in PATHS:
        mesh = None if shape is None else smoke._logical_mesh(shape)
        with _path(tp):
            loop = TrainLoop(smoke.SHARD_AUDIO, global_batch=b, seq=s,
                             schedule=smoke.TRAIN_SCHEDULE, mesh=mesh, cfg_override=cfg,
                             device=smoke.SHARD_DEVICE if mesh is None else None,
                             opt=AdamWConfig(lr=lr, weight_decay=0.0))
            times, losses = smoke._timed_steps(loop)
            with contextlib.redirect_stdout(io.StringIO()):
                loop.run(smoke.SHARD_TRAIN_STEPS, log_every=smoke.SHARD_TRAIN_STEPS)
        first = first or losses
        diffs = [abs(a - c) for a, c in zip(losses, first)]
        where = "" if shape is None else f" on {shape}"
        print(f"[train drift] {cfg.name} loop at peak lr {lr}, {label}{where}: losses "
              f"{[round(x, 6) for x in losses]}; |difference| from one device "
              f"{[float(f'{d:.3e}') for d in diffs]}; ms a step "
              f"{[round(1e3 * t, 1) for t in times]}", flush=True)
        del loop
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, action="append",
                    help="a peak learning rate of the loops, repeatable "
                         "(default 1e-3 and chip_smoke.SHARD_AUDIO_LR)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_drift: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke
    from repro_torch.configs import get_config

    smoke.phase_device()
    smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(smoke.SHARD_AUDIO).scaled(n_layers=smoke.SHARD_AUDIO_LAYERS)
    print(f"[train drift] {cfg.name}, {cfg.n_layers} of 48 layers, {cfg.dtype}, remat "
          f"{cfg.remat!r}, attention {cfg.attention_impl!r}, {smoke.SHARD_AUDIO_SHAPE} frames; "
          f"{smoke.nvidia_smi_line()}", flush=True)
    grads(smoke, cfg)
    for lr in args.lr or [1e-3, smoke.SHARD_AUDIO_LR]:
        loops(smoke, cfg, lr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
