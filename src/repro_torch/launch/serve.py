"""Serving drivers (the counterpart of ``repro.launch.serve``): the LLM
decode loop and the batched stencil engine, on the card unless given
``--device cpu``.

Default (no subcommand): the batched greedy-decoding LLM driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --batch 4 --prompt-len 16 --gen 32 [--device cpu] [--check]

As in JAX it runs the reduced (``SMOKE``) config of ``--arch`` with
parameters drawn from seed 0: cache init, the prompt streamed through the
cached decode step, then ``gen - 1`` greedy steps; it reports tokens/s and,
under ``--check`` (dense family), verifies that the KV-cached stream
matches the argmax of the uncached forward pass.  ``serve_llm`` is the
loop itself, for any config (``chip_smoke.py`` runs it at full width).

``stencil`` subcommand: drive the batched plan-sharing stencil engine
(``repro_torch.serve``) with a closed-loop client -- a fixed window of
outstanding requests over one plan signature -- and report requests/s,
batch occupancy, and P50/P99 latency.

    PYTHONPATH=src python -m repro_torch.launch.serve stencil \\
        --requests 256 --window 16 --shape star --t 2 --grid 256,256
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, SMOKE, ModelConfig
from repro_torch.models import base
from repro_torch.models.api import get_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--check", action="store_true",
                    help="verify the cached decode against the uncached "
                         "forward pass (dense family; see consistency)")
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card; 'cpu' "
                         "runs it on the CPU)")

    sub = ap.add_subparsers(dest="cmd")
    st = sub.add_parser(
        "stencil",
        help="batched plan-sharing stencil serving engine (repro_torch.serve)")
    st.add_argument("--requests", type=int, default=256,
                    help="total requests the closed loop issues")
    st.add_argument("--window", type=int, default=16,
                    help="closed-loop concurrency (outstanding requests)")
    st.add_argument("--shape", choices=("box", "star"), default="star")
    st.add_argument("--radius", type=int, default=1)
    st.add_argument("--t", type=int, default=2, dest="depth",
                    help="fusion depth (time steps per request)")
    st.add_argument("--grid", default="32,32",
                    help="comma-separated grid shape, e.g. 32,32 or 8,16,16")
    st.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    st.add_argument("--max-batch", type=int, default=None,
                    help="override REPRO_SERVE_MAX_BATCH")
    st.add_argument("--timeout-ms", type=int, default=None,
                    help="override REPRO_SERVE_QUEUE_TIMEOUT_MS")
    st.add_argument("--no-guard", action="store_true",
                    help="skip the guarded-execution ladder")
    st.add_argument("--device", default=None,
                    help="where the plans run (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    if getattr(args, "cmd", None) == "stencil":
        # Degenerate loop bounds die with a usage error, not a hang in the
        # closed loop.
        for name in ("requests", "window", "radius", "depth"):
            value = getattr(args, name)
            if value < 1:
                flag = {"depth": "t"}.get(name, name.replace("_", "-"))
                ap.error(f"--{flag} must be >= 1, got {value}")
        for name in ("max_batch", "timeout_ms"):
            value = getattr(args, name)
            floor = 1 if name == "max_batch" else 0
            if value is not None and value < floor:
                ap.error(f"--{name.replace('_', '-')} must be >= {floor}, "
                         f"got {value}")
        try:
            grid = tuple(int(n) for n in args.grid.split(","))
        except ValueError:
            ap.error(f"--grid must be comma-separated integers, "
                     f"got {args.grid!r}")
        if not grid or any(n < 1 for n in grid) or len(grid) > 3:
            ap.error(f"--grid needs 1-3 positive dims, got {args.grid!r}")
        args.grid_shape = grid
        return args
    # --prompt-len 0 would leave the prefill loop body unexecuted; --gen 0
    # would empty the decode loop: usage errors (status 2), as in JAX.
    for name in ("batch", "prompt_len", "gen"):
        value = getattr(args, name)
        if value < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1, got {value}")
    return args


def serve_stencil(args) -> dict:
    """Closed-loop drive of the batched stencil engine; returns (and
    prints) the metrics snapshot."""
    from repro_torch.serve import StencilServer
    from repro_torch.stencil.spec import StencilSpec
    from repro_torch.stencil.weights import jacobi_weights

    spec = StencilSpec(args.shape, len(args.grid_shape), args.radius)
    weights = jacobi_weights(spec)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=args.grid_shape)
                           .astype(np.float32)).to(dtype)
          for _ in range(min(args.window, args.requests))]

    with StencilServer(device=args.device, max_batch=args.max_batch,
                       queue_timeout_ms=args.timeout_ms,
                       guard=not args.no_guard) as server:
        # closed loop: keep `window` requests outstanding, issue a new one
        # as each completes; reuse the window's input tensors round-robin
        outstanding = []
        issued = 0
        t0 = time.perf_counter()
        while issued < args.requests or outstanding:
            while issued < args.requests and len(outstanding) < len(xs):
                outstanding.append(server.submit(
                    weights, xs[issued % len(xs)], t=args.depth))
                issued += 1
            outstanding.pop(0).result()
        wall = time.perf_counter() - t0
        snap = server.stats()
        device = server.device

    lat = snap["latency"]
    print(f"stencil serve: {spec.name} t={args.depth} "
          f"grid={args.grid_shape} dtype={args.dtype} "
          f"guard={not args.no_guard} device={device}")
    print(f"  requests   : {snap['responded']}/{snap['submitted']} "
          f"in {wall:.2f}s wall ({snap['responded']/wall:.0f} req/s)")
    print(f"  batches    : {snap['batches']} "
          f"(occupancy {snap['batch_occupancy']:.2f}, "
          f"degraded {snap['degraded_batches']})")
    print(f"  latency ms : p50={lat['p50_ms']:.2f} p99={lat['p99_ms']:.2f} "
          f"mean={lat['mean_ms']:.2f} max={lat['max_ms']:.2f}")
    pc = snap["plan_cache"]
    print(f"  plan cache : {pc['hits']} hits / {pc['misses']} misses "
          f"({snap['engine_plans']} engine plans)")
    return snap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: The float32 floor of the consistency tolerance, times max(1, max|ref|).
F32_TOL = 1e-4


def consistency(cfg: ModelConfig, params, prompts, tokens, cached,
                length=None) -> dict:
    """The cached decode's logits ``cached`` (B, P+G-1, V) over the stream
    ``prompts`` + ``tokens[:, :-1]`` against the uncached forward pass of
    the same stream (its first ``length`` positions, default all: the
    factored WKV scan needs a length that splits into its chunks), at
    ``cfg.dtype`` and in float32 on the same weights.

    Tolerance: twice the uncached pass's own rounding error
    (max|uncached - uncached float32|: both passes round at ``cfg.dtype``,
    so by the triangle inequality they may differ by the sum of their
    errors), at least ``F32_TOL * max(1, max|uncached|)``.  Holds when the
    logits agree within it and the greedy tokens equal the uncached argmax
    at every position whose top-2 margin exceeds it; the positions under the
    margin are counted, not compared.  (JAX's ``--check`` compares every
    position exactly, which a tie between two bf16 logits can flip.)"""
    P = prompts.shape[1]
    device = cached.device
    full = torch.from_numpy(np.concatenate([prompts, tokens[:, :-1]], axis=1)).to(device)
    if length is not None:
        full, cached, tokens = full[:, :length], cached[:, :length], tokens[:, :length - P + 1]
    with torch.no_grad():
        ref = get_model(cfg).forward_logits(params, full).float()
        ref32 = get_model(dataclasses.replace(cfg, dtype="float32")).forward_logits(
            params, full).float()
    scale = max(1.0, float(ref.abs().max()))
    tol = max(2.0 * float((ref - ref32).abs().max()), F32_TOL * scale)
    err = float((cached.float() - ref).abs().max())
    top2 = torch.topk(ref[:, P - 1:], 2, dim=-1).values
    sure = ((top2[..., 0] - top2[..., 1]) > tol).cpu().numpy()
    want = torch.argmax(ref[:, P - 1:], dim=-1).cpu().numpy()
    tokens_ok = bool(np.array_equal(want[sure], tokens[sure]))
    return {"ok": bool(err <= tol and tokens_ok and np.isfinite(err)),
            "max_abs_err": err, "tol": tol, "ref_max": scale,
            "bf16_err": float((ref - ref32).abs().max()),
            "tokens_ok": tokens_ok, "under_margin": int((~sure).sum()),
            "positions": int(sure.size)}


def serve_llm(cfg: ModelConfig, batch: int = 4, prompt_len: int = 16,
              gen: int = 32, check: bool = False, device=None, params=None,
              keep_logits: bool = False) -> dict:
    """The LLM decode loop of ``main``, for any config: random prompts from
    ``np.random.default_rng(0)``, the prompt streamed through the cached
    decode step, then ``gen - 1`` greedy steps, under ``torch.no_grad()``.

    ``params`` default: ``model.init_params`` from a generator seeded 0 on
    ``device``, stored once in the compute dtype (``serving_params``).
    Returns the prompts and generated tokens (numpy), the prefill / decode
    seconds and tokens/s; with ``keep_logits`` every step's logits
    ``(B, P + G - 1, V)`` on the device; under ``check`` on the dense
    family (JAX's ``--check``), ``check``: ``consistency`` of the cached
    stream with the uncached forward pass."""
    device = base.resolve_device(device)
    model = get_model(cfg)
    B, P, G = batch, prompt_len, gen
    with torch.no_grad():
        if params is None:
            gen_ = torch.Generator(device).manual_seed(0)
            params = base.serving_params(model.init_params(gen_), cfg)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, size=(B, P)).astype(np.int32)
        prompt_t = torch.from_numpy(prompts).to(device)
        caches = model.init_caches(B, P + G + 1, device)
        kept = []
        check = check and cfg.family == "dense"

        def step(caches, token, pos):
            logits, caches = model.decode_logits(params, caches, token, pos)
            if keep_logits or check:
                kept.append(logits)
            return torch.argmax(logits, dim=-1).to(torch.int32), caches

        _sync(device)
        t0 = time.perf_counter()
        for i in range(P):
            nxt, caches = step(caches, prompt_t[:, i:i + 1], i)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out = [nxt]
        t0 = time.perf_counter()
        for i in range(P, P + G - 1):
            nxt, caches = step(caches, out[-1], i)
            out.append(nxt)
        _sync(device)
        t_gen = time.perf_counter() - t0
        tokens = torch.cat(out, dim=1).cpu().numpy()
        result = {"prompts": prompts, "tokens": tokens, "prefill_s": t_prefill, "decode_s": t_gen,
                  "prefill_tok_s": B * P / t_prefill,
                  "decode_tok_s": B * (G - 1) / t_gen if G > 1 else 0.0,
                  "logits": torch.cat(kept, dim=1) if kept else None,
                  "check": None}
    if check:
        result["check"] = consistency(cfg, params, prompts, tokens, result["logits"])
    return result


def main(argv=None):
    args = parse_args(argv)
    if getattr(args, "cmd", None) == "stencil":
        serve_stencil(args)
        return

    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if cfg.family in ("whisper", "vlm", "hybrid", "moe"):
        print(f"note: serve CLI drives dense/rwkv families; {cfg.family} "
              "decode is exercised by the parity tests and chip_smoke.py")
    B, P, G = args.batch, args.prompt_len, args.gen
    r = serve_llm(cfg, B, P, G, check=args.check, device=args.device)
    print(f"arch={cfg.name} B={B} prompt={P} gen={G}")
    print(f"prefill: {r['prefill_s']*1e3:8.1f} ms  ({r['prefill_tok_s']:8.0f} tok/s)")
    print(f"decode : {r['decode_s']*1e3:8.1f} ms  ({r['decode_tok_s']:8.0f} tok/s)")
    print(f"sample completions (first 8 ids): {r['tokens'][:2, :8].tolist()}")
    c = r["check"]
    if c is not None:
        print(f"cached vs uncached logits: max|diff| {c['max_abs_err']:.4g} "
              f"(tol {c['tol']:.4g}); tokens compared at "
              f"{c['positions'] - c['under_margin']} of {c['positions']} "
              f"positions (top-2 margin > tol)")
        print(f"greedy consistency vs uncached forward: "
              f"{'OK' if c['ok'] else 'MISMATCH'}")
        if not c["ok"]:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
