"""Serving driver: batched requests through the OCF prefix-cache index.

Counterpart of ``repro.launch.serve``.  Simulates a request stream with
shared prefixes (the chat-system-prompt pattern); the OCF index decides per
request how many prefix blocks can be reused, the engine prefills the
prompt and decodes greedily, and completed sequences are admitted into the
filter.  The prompts come from ``np.random.RandomState(seed)`` exactly as
in the reference, so the index sees the same keys; the weights come from
``seed`` through the port's own initialiser.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --smoke --device cpu --requests 16 --prefix-len 64 --gen 8
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch


def health_snapshot(metrics, *, index, requests_served: int) -> dict:
    """Liveness + registry snapshot in one dict (a /healthz + /metrics
    pair); here it rides the driver's return value."""
    return {
        "status": "ok",
        "requests_served": requests_served,
        "filter_occupancy": index.ocf.occupancy,
        "prefix_hit_rate": index.hit_rate,
        "metrics": metrics.snapshot() if metrics is not None else {},
    }


def serve(arch: str, *, requests: int, prefix_len: int, gen: int,
          smoke: bool = True, seed: int = 0, block: int = 16,
          metrics=None, tracer=None, device: str = "cuda"):
    """Serve ``requests`` prompts of ``prefix_len + block`` tokens, ``gen``
    tokens each.  ``metrics``/``tracer``: optional ``repro_torch.obs``
    instruments (per-request latency histogram, prefix-reuse counters,
    prefill/decode spans); None records nothing.  Returns the reference's
    keys plus ``prefill_tokens_per_s`` and ``decode_tokens_per_s`` (host
    clock; every decode step ends in a device-to-host read of its token).
    """
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import (greedy_sample, make_decode_step,
                                            make_prefill_step)
    from repro_torch.serving.kvcache import PrefixCacheIndex

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Transformer(cfg, seed=seed, device=device)
    dev = model.device
    rng = np.random.RandomState(seed)
    index = PrefixCacheIndex(block=block, device=device)
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    def span(name, **kw):
        return (tracer.span(name, **kw) if tracer is not None
                else contextlib.nullcontext())

    shared_prefix = rng.randint(0, cfg.vocab_size, prefix_len).astype(np.int32)
    lat, reused_blocks = [], 0
    prefill_s = decode_s = 0.0
    for r in range(requests):
        t0 = time.perf_counter()
        # half the requests share the system prefix (prefix-cache hits)
        if r % 2 == 0:
            prompt = np.concatenate(
                [shared_prefix,
                 rng.randint(0, cfg.vocab_size, block).astype(np.int32)])
        else:
            prompt = rng.randint(0, cfg.vocab_size,
                                 prefix_len + block).astype(np.int32)
        n_cached = index.match_prefix(prompt)
        reused_blocks += n_cached
        # a deployment fetches the cached pages of blocks [0, n_cached);
        # here the engine prefills the whole prompt
        prompt_t = torch.from_numpy(prompt).to(dev)[None, :]
        cache = model.init_cache(1, prompt.size + gen, dtype=torch.float32)
        t1 = time.perf_counter()
        with span("prefill", request=r, prompt_len=int(prompt.size)):
            logits, cache = prefill(cache, prompt_t)
        tok = greedy_sample(logits)
        pos = prompt.size
        out = [int(tok[0, 0])]
        t2 = time.perf_counter()
        with span("decode", request=r, steps=gen - 1):
            for _ in range(gen - 1):
                logits, cache = decode(cache, tok, pos)
                tok = greedy_sample(logits)
                out.append(int(tok[0, 0]))
                pos += 1
        t3 = time.perf_counter()
        prefill_s += t2 - t1
        decode_s += t3 - t2
        index.admit(prompt)
        dt = time.perf_counter() - t0
        lat.append(dt)
        if metrics is not None:
            metrics.counter("serve_requests").inc()
            metrics.counter("serve_prefix_blocks_reused").inc(n_cached)
            metrics.counter("serve_tokens_generated").inc(len(out))
            metrics.histogram(
                "serve_request_latency_us",
                buckets=(1e3, 1e4, 1e5, 1e6, 1e7)).observe(dt * 1e6)
    result = {
        "latency_mean_s": float(np.mean(lat)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "prefix_hit_rate": index.hit_rate,
        "reused_blocks": reused_blocks,
        "index_stats": index.stats,
        "ocf_stats": index.ocf.stats,
        "filter_occupancy": index.ocf.occupancy,
        "prefill_tokens_per_s": requests * (prefix_len + block) / prefill_s,
        "decode_tokens_per_s": (requests * (gen - 1) / decode_s
                                if decode_s > 0 else 0.0),
    }
    if metrics is not None:
        result["health"] = health_snapshot(metrics, index=index,
                                           requests_served=requests)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefix-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--telemetry", action="store_true",
                    help="record request metrics + trace spans; prints the "
                         "health/metrics snapshot (Prometheus text) and "
                         "writes serve_metrics.jsonl / serve_trace.json")
    ap.add_argument("--telemetry-dir", default=".",
                    help="directory for --telemetry artifacts")
    args = ap.parse_args()
    metrics = tracer = None
    if args.telemetry:
        from repro_torch.obs import MetricsRegistry, TraceRecorder
        metrics = MetricsRegistry()
        tracer = TraceRecorder(process_name="serve")
    out = serve(args.arch, requests=args.requests, prefix_len=args.prefix_len,
                gen=args.gen, smoke=args.smoke, metrics=metrics,
                tracer=tracer, device=args.device)
    for k, v in out.items():
        if k != "health":
            print(f"{k}: {v}")
    if args.telemetry:
        import os
        os.makedirs(args.telemetry_dir, exist_ok=True)
        mpath = os.path.join(args.telemetry_dir, "serve_metrics.jsonl")
        tpath = os.path.join(args.telemetry_dir, "serve_trace.json")
        metrics.to_jsonl(mpath)
        tracer.save(tpath)
        print(f"health: {out['health']['status']} "
              f"(requests_served={out['health']['requests_served']})")
        print(metrics.prometheus_text(), end="")
        print(f"metrics -> {mpath}\ntrace -> {tpath}")


if __name__ == "__main__":
    main()
