"""Fault-tolerant training driver, on one device or on a mesh.

Port of ``src/repro/launch/train.py``: deterministic data replay, async
checkpointing with atomic commit, auto-resume after (injected) failures and
straggler monitoring, on the card unless ``device="cpu"`` is asked. With a
mesh (``distributed.Mesh``, e.g. ``launch/mesh.py::make_host_mesh``) the
state lives in the blocks of ``train_state_specs`` and each step is the
sharded one of ``launch/steps.py``; a restore places the checkpoint on the
loop's mesh, whatever mesh wrote it (the elastic restore).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \
        --steps 200 --global-batch 8 --seq 128 --ckpt-dir build/ckpt --device cpu
    # the same on a 2 x 2 mesh of logical shards of the run's device:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \
        --device cpu --data 2 --model 2
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed.ctx import activation_scope
from repro_torch.distributed.lm_sharding import batch_spec_tree, named_tree, train_state_specs
from repro_torch.distributed.mesh import mesh_device
from repro_torch.distributed.sharding import place_tree
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import init_model, model_schema
from repro_torch.models.params import tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FailureInjector, StragglerMonitor
from repro_torch.runtime.fault import SimulatedFailure
from repro_torch.runtime.staging import stage

__all__ = ["TrainLoop", "run_with_auto_resume", "main"]


class TrainLoop:
    """Train one model on the synthetic token stream.

    Without ``mesh`` the loop runs on ``device``: the card unless ``"cpu"``
    is asked. With ``mesh`` it runs the sharded step over the mesh's
    devices (``device``, if given, must be of the mesh's kind), under the
    mesh's ``activation_scope``. ``schedule`` updates ``make_train_step``'s
    default learning-rate schedule (the reference's loop keeps the default).
    """

    def __init__(
        self,
        arch: str,
        *,
        smoke: bool = False,
        global_batch: int = 8,
        seq: int = 128,
        mesh=None,
        device=None,
        ckpt_dir: str | None = None,
        ckpt_every: int = 50,
        microbatches: int = 1,
        opt: AdamWConfig | None = None,
        schedule: dict | None = None,
        seed: int = 0,
        cfg_override=None,
    ):
        if cfg_override is not None:
            self.cfg = cfg_override
        else:
            self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        self.arch = arch
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh_device(mesh, device)
        self.ds = SyntheticLMDataset(
            vocab=self.cfg.vocab,
            seq_len=seq,
            global_batch=global_batch,
            seed=seed,
            family=self.cfg.family,
            d_frontend=self.cfg.d_frontend,
            n_image_tokens=self.cfg.n_image_tokens,
        )
        self.opt_cfg = opt or AdamWConfig(lr=1e-3, weight_decay=0.0)
        batch0 = self.ds.batch(0)
        self.step_fn = make_train_step(self.cfg, self.opt_cfg, schedule=schedule,
                                       microbatches=microbatches, mesh=mesh, batch_sds=batch0)
        if mesh is not None:
            pspecs, ospecs, _ = train_state_specs(self.cfg)
            self.param_sh = named_tree(mesh, pspecs)
            self.opt_sh = named_tree(mesh, ospecs)
            self.batch_sh = named_tree(mesh, batch_spec_tree(self.cfg, mesh, batch0))
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor()
        self.metrics_log: list[dict] = []

    def init_state(self):
        """Parameters from seed 0 (the reference's ``PRNGKey(0)``, whatever
        ``seed`` is) and fresh AdamW state, on the loop's device; on a mesh
        drawn on its first device, then placed by ``train_state_specs`` (the
        weights of the one-device loop)."""
        params = init_model(0, self.cfg, self.device)
        opt_state = adamw_init(params)
        if self.mesh is None:
            return params, opt_state
        return place_tree(params, self.param_sh), place_tree(opt_state, self.opt_sh)

    def restore_or_init(self):
        """(params, opt_state, first step): the latest committed checkpoint,
        or a fresh state at step 0.

        A save still in flight from this process (a failure injected right
        after ``save_async``) is joined first, so the restart resumes from
        it; the reference reads ``latest_step`` without joining, and resumes
        from an earlier step or step 0 when its writer thread is slower than
        the steps to the failure."""
        if self.ckpt:
            self.ckpt.wait()
        if self.ckpt and self.ckpt.latest_step() is not None:
            schema = model_schema(self.cfg)
            like = {"params": schema,
                    "opt": {"m": schema, "v": schema, "step": np.zeros((), np.int32)}}
            if self.mesh is not None:
                state, step, _ = self.ckpt.restore(
                    like, shardings={"params": self.param_sh, "opt": self.opt_sh})
                return state["params"], state["opt"], step
            state, step, _ = self.ckpt.restore(like)
            state = tree_map(lambda a: stage(a, self.device, non_blocking=False), state)
            return state["params"], state["opt"], step
        params, opt_state = self.init_state()
        return params, opt_state, 0

    def _batch(self, step: int) -> dict:
        batch = self.ds.batch(step)
        if self.mesh is None:
            return {k: stage(v, self.device) for k, v in batch.items()}
        return place_tree(batch, self.batch_sh)

    def run(self, steps: int, injector: FailureInjector | None = None,
            log_every: int = 10):
        scope = (contextlib.nullcontext() if self.mesh is None
                 else activation_scope(self.cfg, self.mesh))
        with scope:
            return self._run(steps, injector, log_every)

    def _run(self, steps: int, injector: FailureInjector | None, log_every: int):
        params, opt_state, start = self.restore_or_init()
        straggler_flags = 0
        for step in range(start, steps):
            if injector:
                injector.check(step)
            self.monitor.start_step()
            batch = self._batch(step)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            if self.monitor.end_step():
                straggler_flags += 1
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save_async(
                    step + 1, {"params": params, "opt": opt_state},
                    extra={"arch": self.arch},
                )
            if (step + 1) % log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                self.metrics_log.append(m)
                print(
                    f"step {step + 1:5d} loss={m['loss']:.4f} "
                    f"gnorm={m.get('grad_norm', 0):.3f} lr={m.get('lr', 0):.2e}"
                )
        if self.ckpt:
            self.ckpt.save(steps, {"params": params, "opt": opt_state},
                           extra={"arch": self.arch})
            self.ckpt.wait()
        return params, opt_state, straggler_flags


def run_with_auto_resume(loop: TrainLoop, steps: int,
                         injector: FailureInjector | None = None,
                         max_restarts: int = 5):
    """The outer supervisor: restart from the last checkpoint on failure."""
    restarts = 0
    while True:
        try:
            return loop.run(steps, injector=injector), restarts
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"[supervisor] {e}; restarting ({restarts}/{max_restarts})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--data", type=int, default=1,
                    help="data-axis size of a mesh of logical shards of the run's device")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis size of that mesh (--data 1 --model 1: no mesh)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    mesh = None
    if (args.data, args.model) != (1, 1):
        dev = resolve_device(args.device)
        mesh = make_host_mesh(args.data, args.model, devices=[dev] * (args.data * args.model))
    loop = TrainLoop(
        args.arch,
        smoke=args.smoke,
        global_batch=args.global_batch,
        seq=args.seq,
        mesh=mesh,
        device=args.device,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
    )
    injector = FailureInjector(tuple(args.fail_at)) if args.fail_at else None
    t0 = time.time()
    (_, _, straggler_flags), restarts = run_with_auto_resume(loop, args.steps, injector)
    dt = time.time() - t0
    print(
        f"done: {args.steps} steps in {dt:.1f}s "
        f"({args.steps / dt:.2f} steps/s), restarts={restarts}, "
        f"straggler_flags={straggler_flags}"
    )
    losses = [m["loss"] for m in loop.metrics_log]
    if losses:
        print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
