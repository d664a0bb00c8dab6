"""Serving through the OCF prefix-cache index on the PyTorch/CUDA port.

The chat pattern: many requests share a system prefix.  The OCF answers
"which prefix blocks are already cached?" before any prefill, evictions
delete from the filter, and the admission burst drives EOF resizing
(``repro_torch.launch.serve``, the reduced config of ``--arch``).  On the
card by default, on the CPU with ``--device cpu``:

    PYTHONPATH=src python examples/torch_serve_with_prefix_cache.py \\
        --arch mistral-nemo-12b --requests 24
"""
import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prefix-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    out = serve(args.arch, requests=args.requests,
                prefix_len=args.prefix_len, gen=args.gen, smoke=True,
                device=args.device)
    print(f"requests: {args.requests}")
    print(f"mean latency: {out['latency_mean_s']*1e3:.1f} ms   "
          f"p99: {out['latency_p99_s']*1e3:.1f} ms")
    print(f"prefix-cache hit rate: {out['prefix_hit_rate']:.1%} "
          f"({out['reused_blocks']} blocks reused)")
    print(f"index: {out['index_stats']}")
    print(f"filter: occupancy={out['filter_occupancy']:.3f} "
          f"{out['ocf_stats']}")
    if args.requests > 1:
        assert out["reused_blocks"] > 0, "shared prefixes must hit the OCF"


if __name__ == "__main__":
    main()
