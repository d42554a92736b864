"""Batched LM serving driver: prefill a prompt batch, decode N tokens.

Port of ``src/repro/launch/serve.py`` on one device, for every decoder
family (dense GQA or MLA, moe, ssm, hybrid, vlm; the audio encoder has no
decode step and raises, as the reference's does):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --attention-impl flash --batch 8 --prompt-len 4096 --gen 32

With ``attention_impl="flash"`` the prefill runs the CUDA flash-attention
kernel (one launch an attention layer, a vlm's cross layers included);
decode is plain torch, as the reference's decode never calls its kernel.
``--device cpu`` runs the plain versions. A vlm's prompts come with image
embeddings ``[B, n_image_tokens, d_frontend]`` (the CLI draws them from a
seed).

``ServeSession(mesh=)`` serves on a ``repro_torch.distributed.Mesh``, as
the reference's does: the parameters placed by ``train_state_specs``, each
prompt batch by ``batch_spec_tree`` and the cache by ``cache_spec_tree``
(its sequence over 'model': decode attention runs one partial a block and
a logsumexp combine; the SSM's heads over 'model'), through
``make_prefill_step``/``make_serve_step`` on the mesh. Logical shards of one
card (``make_host_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4)``) or
of the host (``torch.device("cpu")`` entries) run every placement on one
device. ``generate`` gathers the parameters once and frees them after the
call (the reference's GSPMD gathers ZeRO-3 blocks each step: the same
results on another schedule): the dense, MoE, VLM, SSM and hybrid decoders
on the "tp" profile (deepseek-67b, qwen1.5-110b, moonshot-v1-16b-a3b,
dbrx-132b, llama-3.2-vision-90b, mamba2-780m, zamba2-7b) gather over
'data' only, each position its 'model' block, and serve tensor-parallel
(heads, columns, experts, SSM heads and vocab a shard,
``distributed/tensor_parallel.py``); every other config gathers every
parameter whole on each distinct device.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.lm_sharding import cache_spec_tree
from repro_torch.distributed.mesh import Mesh, _as_device
from repro_torch.distributed.sharding import named_tree, zeros
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.steps import (
    gather_params,
    make_prefill_step,
    make_serve_step,
    place_params,
)
from repro_torch.models.model import cache_zeros, init_cache, init_model
from repro_torch.models.params import tree_map
from repro_torch.runtime.staging import stage

__all__ = ["ServeSession", "main"]


class ServeSession:
    """Greedy (or seeded temperature) generation for one batch shape.

    ``device`` is the card unless ``"cpu"`` is asked; with ``mesh`` (a
    ``repro_torch.distributed.Mesh``) it is the mesh's first device, where
    prompts, logits and sampling live (a ``device`` that disagrees raises
    ``ValueError``), and the session serves on the mesh (module docstring).
    ``attention_impl``, ``dtype`` and ``n_layers``, when set, replace the
    config's fields (the reference keeps the config's, ``"xla"`` and
    bf16 at the full depth; a cut depth serves a config at full width on one
    card).
    ``params`` (the port's parameter tree, e.g. from ``params_from_numpy``)
    replaces the session's own init from seed 0, which the reference also
    uses whatever ``seed`` is; ``seed`` seeds temperature sampling.

    ``generate`` is the serving entry point. ``prefill`` and ``decode`` are
    its two steps, exposed so that checks can hold each step's logits and
    cache against another session's; ``dtype``, ``params`` and
    ``generate(keep_logits=)`` exist for those checks too.
    """

    def __init__(self, arch: str, *, smoke=False, batch=4, max_seq=128, mesh=None,
                 temperature: float = 0.0, seed: int = 0, device=None,
                 attention_impl: str | None = None, dtype: str | None = None,
                 n_layers: int | None = None, params=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise ValueError(f"mesh must be a repro_torch.distributed.Mesh, got "
                             f"{type(mesh).__name__}")
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if cfg.family == "audio":
            raise ValueError("encoder-only arch has no decode step")
        overrides = {"attention_impl": attention_impl, "dtype": dtype, "n_layers": n_layers}
        cfg = cfg.scaled(**{k: v for k, v in overrides.items() if v is not None})
        if cfg.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', got {cfg.attention_impl!r}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices.flat[0]
            if device is not None and _as_device(device) != self.device:
                raise ValueError(f"device {str(device)!r} disagrees with the mesh's first device "
                                 f"{self.device}")
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is None:
            params = init_model(0, cfg, self.device)
        elif mesh is None:
            params = tree_map(lambda t: stage(t, self.device, non_blocking=False), params)
        self.params = params if mesh is None else place_params(cfg, mesh, params)
        self._full = None  # the parameters gathered for the running generate
        self._prefill = make_prefill_step(cfg, mesh)
        self._decode = make_serve_step(cfg, mesh)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, prompts, image_embeds=None):
        """prompts: [B, P] ints; ``image_embeds`` [B, n_image_tokens,
        d_frontend] (a NumPy array or tensor), which a vlm needs and other
        families refuse. Returns (last logits [B, V] f32, cache)."""
        tokens = stage(np.asarray(prompts).astype(np.int32), self.device, non_blocking=False)
        if tokens.dim() != 2 or tokens.shape[0] != self.batch:
            raise ValueError(f"prompts must be [{self.batch}, P], got {tuple(tokens.shape)}")
        batch = {"tokens": tokens}
        if (image_embeds is None) == (self.cfg.family == "vlm"):
            raise ValueError(f"image_embeds are given for a {self.cfg.family} arch"
                             if image_embeds is not None else "a vlm prompt needs image_embeds")
        if image_embeds is not None:
            batch["image_embeds"] = stage(image_embeds, self.device, non_blocking=False)
        return self._prefill(self._params(), self._new_cache(), batch)

    def _new_cache(self):
        if self.mesh is None:
            return init_cache(self.cfg, self.batch, self.max_seq, self.device)
        shapes = cache_zeros(self.cfg, self.batch, self.max_seq, torch.device("meta"))
        shardings = named_tree(self.mesh, cache_spec_tree(self.cfg, self.mesh, shapes))
        return tree_map(lambda t, sh: zeros(t.shape, t.dtype, sh), shapes, shardings)

    def _params(self):
        return self.params if self._full is None else self._full

    @contextlib.contextmanager
    def gathered(self):
        """On a mesh, the parameters gathered once for the steps run inside
        (``generate`` runs in it; ``launch/steps.py::gather_params``: each
        position's model blocks on the tensor-parallel path, the whole tree
        on each distinct device on the gathered one), and freed after;
        without a mesh, nothing. Outside it each sharded step gathers for
        itself."""
        if self.mesh is None or self._full is not None:
            yield
            return
        self._full = gather_params(self.params, self.mesh, self.cfg)
        try:
            yield
        finally:
            self._full = None

    def decode(self, cache, token: torch.Tensor, pos: int):
        """One step: token [B, 1] at position ``pos``. Returns (logits, cache)."""
        return self._decode(self._params(), cache, token, pos)

    def generate(self, prompts: np.ndarray, gen_tokens: int, image_embeds=None,
                 keep_logits: bool = False):
        """prompts: [B, P] int32 (a vlm's with ``image_embeds``). Returns
        (tokens [B, P+gen], stats).

        ``stats`` has the reference's ``prefill_s`` (on a mesh, the gather of
        the parameters included), ``decode_s`` and ``decode_tok_per_s``; with
        ``keep_logits`` also ``logits``, the [gen, B, V] f32 logits each
        sampled token was drawn from.
        """
        b, plen = prompts.shape
        self._sync()
        t0 = time.perf_counter()
        with self.gathered():  # on a mesh the gather counts in prefill_s
            logits, cache = self.prefill(prompts, image_embeds)
            self._sync()
            t_prefill = time.perf_counter() - t0
            kept = [logits] if keep_logits else []
            out = [self._sample(logits)]
            t0 = time.perf_counter()
            for i in range(gen_tokens - 1):
                logits, cache = self.decode(cache, out[-1], plen + i)
                if keep_logits:
                    kept.append(logits)
                out.append(self._sample(logits))
            self._sync()
            t_decode = time.perf_counter() - t0
        gen = torch.cat(out, dim=1).cpu().numpy()
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": b * max(gen_tokens - 1, 1) / max(t_decode, 1e-9),
        }
        if keep_logits:
            stats["logits"] = torch.stack(kept).cpu().numpy()
        return np.concatenate([prompts, gen.astype(prompts.dtype)], axis=1), stats

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen).to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--attention-impl", choices=("xla", "flash"), default=None,
                    help="replaces the config's attention_impl (xla)")
    args = ap.parse_args(argv)
    sess = ServeSession(
        args.arch,
        smoke=args.smoke,
        batch=args.batch,
        max_seq=args.prompt_len + args.gen + 1,
        temperature=args.temperature,
        device=args.device,
        attention_impl=args.attention_impl,
    )
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, sess.cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    img = None
    if sess.cfg.family == "vlm":
        img = rng.normal(size=(args.batch, sess.cfg.n_image_tokens, sess.cfg.d_frontend))
        img = img.astype(np.float32)
    tokens, stats = sess.generate(prompts, args.gen, image_embeds=img)
    print(f"generated shape={tokens.shape} prefill={stats['prefill_s']:.3f}s "
          f"decode={stats['decode_s']:.3f}s ({stats['decode_tok_per_s']:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
