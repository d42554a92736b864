#!/usr/bin/env python3
"""How far bf16 serving on a mesh lands from one device, path by path.

    PYTHONPATH=src python3 tools/tp_drift.py [--arch ARCH[:LAYERS]] ...

Each ``--arch`` (default deepseek-67b:8; LAYERS cuts the depth, none: every
layer) at full width, bf16, on logical shards of one card: 4 x 512 prompt
tokens and 16 steps (chip_smoke's phase 21d shape) teacher-forced on
the one-device session's tokens (the VLM's image embeddings as 21d draws
them, ``chip_smoke._image_embeds``; the SSM and hybrid configs' conv taps
passing their input and the MLA config's query latent norms scaled as 21d
sets them, ``chip_smoke._passing_conv`` and ``_sharp_mla``), under
``chip_smoke.SERVE_SHARD_IMPL``'s attention ("xla" for minicpm3-4b, whose
MLA values the flash kernel refuses; "flash" for a config not there), for

  * a config that serves tensor-parallel (``serves_tensor_parallel``: the
    dense, MLA, MoE, VLM, SSM and hybrid decoders on the "tp" profile, e.g.
    ``--arch mamba2-780m:48 --arch minicpm3-4b``): the tensor-parallel
    path on 2 x 2, 1 x 2 and 2 x 1 (on 2 x 1 the model axis splits
    nothing: only the data split and
    the path's float32 reductions differ from one device), and the gathered
    path on 2 x 2 (every parameter gathered whole; ``serves_tensor_parallel``
    patched off), and, for a config that phase 21b serves pinned to another
    profile (``chip_smoke.SERVE_SHARD_PROFILE``: minicpm3-4b on "dp"), the
    gathered path on that profile on 2 x 2;
  * any other config: the gathered path on 2 x 2, 2 x 1 and 1 x 2.

The audio encoder (``--arch hubert-xlarge:48``) has no decode step: on 4 x
512 frames (``chip_smoke._audio_frames``, 21d's shape) under "flash" it
reads the prefill step's last logits and the full-frame logits
(``launch/steps.py::make_forward_step``: ``forward_tp`` on the tensor-parallel path,
``forward_train`` on the gathered one) on the tensor-parallel path on 2 x
2, 1 x 2 and 2 x 1 and on the gathered path pinned "dp" on 2 x 2, each
against one device's (``make_prefill_step(cfg)``, ``forward_train``) and a
float32 run's of the same weights.

Each prints the logits' relative norm against the one-device session and
against a float32 run of the same weights (the max over the steps), the
prefill's and the largest decode step's. The bf16 runs' distance from
float32 sets the scale: two bf16 runs whose roundings part anywhere land
about that far apart. Phase 21d sets its bf16 bounds from these readings. Needs one NVIDIA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TP_PATHS = (("tensor-parallel", (2, 2)), ("tensor-parallel", (1, 2)), ("tensor-parallel", (2, 1)),
            ("gathered", (2, 2)))
GATHERED_PATHS = (("gathered", (2, 2)), ("gathered", (2, 1)), ("gathered", (1, 2)))


def _spec(text: str) -> tuple[str, int | None]:
    arch, _, layers = text.partition(":")
    return arch, int(layers) if layers else None


def drift(smoke, arch: str, layers: int | None) -> None:
    """Print one config's readings (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    full = get_config(arch)
    cfg = full.scaled(n_layers=layers) if layers else full
    b, plen, gen = smoke.FAMILY_BATCH, smoke.FAMILY_PROMPT, smoke.FAMILY_GEN
    impl = smoke.SERVE_SHARD_IMPL.get(arch, "flash")
    torch.cuda.empty_cache()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    smoke._open_gates(params)
    smoke._passing_conv(params)
    smoke._sharp_mla(params, cfg)
    rng = np.random.default_rng(23)
    prompts = rng.integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    img = smoke._image_embeds(rng, b, cfg) if cfg.family == "vlm" else None
    common = dict(batch=b, max_seq=plen + gen, attention_impl=impl, n_layers=layers)
    tokens, stats = ServeSession(arch, params=params, **common).generate(
        prompts, gen, image_embeds=img, keep_logits=True)
    forced = tokens[:, plen:]
    f32 = ServeSession(arch, params=tree_map(lambda t: t.float(), params), dtype="float32",
                       **common)
    exact = smoke._forced(f32, prompts, img, forced)[0]
    del f32
    torch.cuda.empty_cache()
    one_f32 = smoke._step_rels(torch.as_tensor(stats["logits"]), exact, cfg.vocab)
    cut = f"{layers} layers" if layers else f"all {full.n_layers} layers"
    print(f"[tp drift] {arch}, {cut}, bf16, attention {impl!r}, {b} x {plen} + {gen}; one device "
          f"against float32: prefill {one_f32[0]:.6f}, decode max {max(one_f32[1:]):.6f}; "
          f"{smoke.nvidia_smi_line()}", flush=True)
    real = steps.serves_tensor_parallel
    tp = real(cfg, smoke._logical_mesh((2, 2)))
    profile = smoke.SERVE_SHARD_PROFILE.get(arch)
    paths = [(p, s, None) for p, s in (TP_PATHS if tp else GATHERED_PATHS)]
    if profile:
        paths.append((f"gathered (profile {profile!r})", (2, 2), profile))
    for path, shape, pinned in paths:
        if path == "gathered":
            steps.serves_tensor_parallel = lambda cfg, mesh: False
        try:
            with smoke._pinned_profile(pinned):
                sess = ServeSession(arch, mesh=smoke._logical_mesh(shape), params=params,
                                    **common)
            got = smoke._forced(sess, prompts, img, forced)[0]
        finally:
            steps.serves_tensor_parallel = real
        del sess
        torch.cuda.empty_cache()
        rels = smoke._step_rels(got, stats["logits"], cfg.vocab)
        to_f32 = smoke._step_rels(got, exact, cfg.vocab)
        print(f"[tp drift] {arch} {path} on {shape}: against one device prefill {rels[0]:.6f}, "
              f"decode max {max(rels[1:]):.6f}; against float32 prefill {to_f32[0]:.6f}, decode "
              f"max {max(to_f32[1:]):.6f}", flush=True)
    del params


def drift_audio(smoke, arch: str, layers: int | None) -> None:
    """Print the audio encoder's readings (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (
        gather_params,
        make_forward_step,
        make_prefill_step,
        place_params,
    )
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    full = get_config(arch)
    cfg = (full.scaled(n_layers=layers) if layers else full).scaled(
        attention_impl=smoke.SERVE_SHARD_IMPL.get(arch, "flash"))
    torch.cuda.empty_cache()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    frames = torch.from_numpy(smoke._audio_frames(np.random.default_rng(23), cfg)).cuda()
    vocab = cfg.vocab
    one = smoke._audio_one_device(cfg, params, frames)[:2]
    exact = smoke._audio_one_device(cfg.scaled(dtype="float32"),
                                    tree_map(lambda t: t.float(), params), frames)[:2]
    torch.cuda.empty_cache()

    def rels(got, want):
        return [smoke._rel(g[..., :vocab], w[..., :vocab]) for g, w in zip(got, want)]

    one_f32 = rels(one, exact)
    cut = f"{layers} layers" if layers else f"all {full.n_layers} layers"
    b, s = smoke.AUDIO_TP_SHAPE
    print(f"[tp drift] {arch}, {cut}, bf16, attention {cfg.attention_impl!r}, {b} x {s} frames; "
          f"one device against float32: last {one_f32[0]:.6f}, full-frame {one_f32[1]:.6f}; "
          f"{smoke.nvidia_smi_line()}", flush=True)
    paths = [(p, s, None) for p, s in TP_PATHS if p == "tensor-parallel"]
    for path, shape, profile in paths + [("gathered (profile 'dp')", (2, 2), "dp")]:
        c = cfg.scaled(parallelism=profile) if profile else cfg
        mesh = smoke._logical_mesh(shape)
        blocks = gather_params(place_params(c, mesh, params), mesh, c)
        got = (make_prefill_step(c, mesh)(blocks, {}, {"frames": frames})[0],
               make_forward_step(c, mesh)(blocks, {"frames": frames}))
        del blocks
        torch.cuda.empty_cache()
        near, to_f32 = rels(got, one), rels(got, exact)
        print(f"[tp drift] {arch} {path} on {shape}: against one device last {near[0]:.6f}, "
              f"full-frame {near[1]:.6f}; against float32 last {to_f32[0]:.6f}, full-frame "
              f"{to_f32[1]:.6f}", flush=True)
    del params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=_spec, action="append",
                    help="ARCH[:LAYERS], repeatable (default deepseek-67b:8)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_drift: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as smoke

    smoke.phase_device()
    smoke.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config

    for arch, layers in args.arch or [("deepseek-67b", 8)]:
        (drift_audio if get_config(arch).family == "audio" else drift)(smoke, arch, layers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
