#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each timed, each fatal on failure:

  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit, at main-path shapes (4096-key chunks, 16M-slot tables,
     the parity block): the four OCF kernels (insert and delete also on
     STAGING_CASES, which stress their rows staged in shared memory), the
     four adaptive ones on a four-plane state with nonzero selectors
     (insert and delete also on ADAPTIVE_STAGING_CASES, and once split
     into launches of fewer keys than a call; probe_adaptive also on
     PROBE_ADAPTIVE_CASES: full, empty and multi-pass stashes, entries
     that share a key's fingerprint or fold but not its buckets, fp_bits
     32 and 8, slots holding a family fingerprint under another selector,
     bucket sizes 1, 2 and 8, 1 to 1.1M keys; the tables and their inputs
     come from ``repro_torch.kernels.staging_cases``, as in the tests), and
     ``probe_multi`` over K = 1, 2, 4 of four generation tables
     int32[4, 2^20, 4], pools of 65 and 130 slots, and PROBE_MULTI_CASES
     (full stashes, fingerprints that share a key's 16-bit fold, fp_bits 32
     and 8, live slots in any order, ragged n, bucket sizes 2 and 8); the
     four telemetry instantiations (``probe_tm``, ``insert_bulk_tm``,
     ``probe_adaptive_tm``, ``insert_bulk_adaptive_tm``) against their
     plain versions with stats (answers, tables and counter planes) and
     against the flag-off kernels, on the same cases and on PROBE_CASES
     (with and without a stash: padding lanes that hit and must not count,
     n of 1, 1000, 4097 and 20000, full stashes, a key's fingerprint at a
     third bucket, 32-bit fingerprints of one 16-bit fold, 8-bit ones,
     stashes of 1, 1025 and 2500 slots, bucket sizes 1 and 8), ``probe``
     on the same; ``fingerprint_hash`` on FINGERPRINT_CASES (n of 1, 3,
     4097, 2^17 + 5 and 2^19 + 5, key views aligned and one element in);
     and
     ``flash_attention`` within a stated tolerance at gemma3-1b's shapes
     (Hq=4, Hkv=1, S=8192, D=256; float32 and bfloat16; window 512 and
     none), small cases of the reference's sweep, a case with Sq > Skv and
     lengths (200, 300) that end in ragged tiles, and deepseek-v2-lite's
     MLA heads through ``ops.attention`` (Hq = Hkv = 16, q and k of 192, v
     of 128, zero-padded to 256: bfloat16 at S = 8192 and 200, float32 at
     1024), and in bfloat16 the shapes of phase 5h's forwards
     (recurrentgemma-2b's local layers: a GQA group of 10, D 256, window
     2048; musicgen-large's self-attention and its non-causal
     cross-attention, Sq 8192 over 256 memory frames; llava's 32 / 8 heads
     at D 128; nemotron's 48 / 8 at 4096); and the scan backend's
     ``scan_insert`` and ``scan_delete`` on SCAN_CASES (key mode on a
     2^12-bucket table driven to load 0.97 by 2^14 keys, pair mode into a
     16-slot stash that fills, 2^14 deletes with duplicates, a stack of
     shards in one launch, crowded rows, self-pairs, deletes of one
     fingerprint across one bucket pair), each insert case at windows of
     1, 32 and ``MAX_WINDOW`` lanes with its schedule's shares; and
     flash attention's backward kernels (``csrc/flash_attention_bwd.cu``:
     the pre-pass, dk/dv, dq) against their plain version on every
     flash case above in float32 and bfloat16, at gemma3-1b's training
     shapes (bfloat16, S 4096, window 512 and global, B 1 and 2), on
     gemma3-1b's heads at D 64 and 128 and a soft-capped, windowed,
     ragged D 256 case, and on MLA's padded heads through
     ``ops.attention`` under autograd (FLASH_BWD_TOL elementwise and by
     row; in float32 also against ``torch.autograd.grad`` through the
     plain forward; in bfloat16 a second run gives the same bits), with
     the forward's ``lse`` against the plain version's;
  3. run seeded streams through the card and the CPU and require
     identical state and answers after every operation: ~100k-key EOF
     streams through ``OCF`` (with and without a stash), two
     ``AdaptiveMembership`` streams (inserts, lookups, reports, deletes;
     one at load ~0.95 with kicks of adapted slots), a ~100k-event
     ``GenerationalFilter`` stream (rotations, TTL expiries, spills, a
     rotate-and-retry), a ``GenerationalPrefixIndex`` stream, two
     ``FilterOpBatcher`` wave streams with telemetry on (a static filter
     with an 8-slot stash, an adaptive one with report waves: waves,
     states and every counter of the registry equal); the six scenarios
     of the SLO harness through ``run_scenario`` at the reference's sizes
     (every wave's results, the final state and every report field that
     is no host time equal); the LM at gemma3-1b's full width and one
     period's depth (6 layers, float32, TF32 off), built on the CPU and
     copied to the card: forward logits within a stated tolerance at S =
     512 and 200, greedy tokens of prefill + 8 decode steps equal;
     ``ContinuousBatcher`` over that model, a burst of 7 requests into 3
     slots (greedy tokens and ``SchedStats`` equal); deepseek-v2-lite-16b
     at full width and 3 layers (the dense MLA prefix, 2 MoE blocks),
     float32, TF32 off, built on the CPU and copied to the card: at S =
     512 (one routing group) and 1024 (two) each layer on the CPU's input
     to it on both devices (expert choices equal but at a near tie of
     gate gap <= 1e-5, printed; ``keep`` equal; outputs row by row within
     1e-4), then logits within 1e-3 and the aux loss within 1e-6, and the
     greedy tokens of prefill + 8 decode steps equal; mamba2-1.3b (2
     layers), recurrentgemma-2b (3: rglru, rglru, local), musicgen-large
     (2, with a seeded memory), llava-next-mistral-7b (2, with 128 seeded
     prefix embeddings) and nemotron-4-15b (2), each at full width,
     float32, TF32 off, built on the card and copied to the CPU: logits
     within 1e-3, greedy tokens of prefill + 4 decode steps equal; one
     training step of gemma3-1b at full width and 6 layers (float32, TF32
     off, batch 2 x 256, the same weights and AdamW state): loss,
     grad_norm, every gradient leaf and the parameters after the step
     card vs CPU, and the OCF-dedup data pipeline card vs CPU through
     shard retirements (batches, ``PipelineStats`` and OCF stats equal);
     and a sharded-filter
     stream on both backends (2 shards x 2^12 buckets x 4, a 128-slot
     stash, both routes at a capacity that defers, a split to 4 and a
     merge back in several rounds; tables, stashes, ok, deferred, overflow
     and hits equal after every step);
  4. the OCF main path at full size: one node's membership filter of a
     distributed store (capacity 2^22 slots, 8 bursts of 1M inserts, 3M
     verified + 100k blind deletes, lookups of every resident key plus 5M
     absent ones), with its kernels' launch counts read around it;
  5. the adaptive path at full size: an abuse-detection denylist of one
     node (2^22 buckets of 4, 12 bursts of 1M members, 4 feedback rounds
     over 10M replayed benign keys, 3M deletes), launch counts read
     around it;
  5b. the streaming path at full size: the dedup stage of one node
     (``examples/streaming_dedup.py`` at scale: a ring of 4 generations
     of 2^22 slots, 32 ticks of 600k events with a 4x burst, 40% repeats),
     then the TTL step; launch counts read around it;
  5d. filter-op waves at full size: the filter's serving front
     (``FilterOpBatcher``, 4096-key waves, double-buffered) over 2^20
     buckets of 4 with a 128-slot stash: inserts to load 0.85, lookups of
     every acknowledged key and a quarter as many absent ones, deletes of
     a quarter (``WAVE_CUT``); the same over the adaptive planes with
     report waves; each with telemetry off and on in turns (off, on, on,
     off: equal results and states, the counter sums checked, no
     telemetry launch in the off arm, the median walls), then each under
     a trace for the device's idle share;
  5e. SLO scenarios at node size: each scenario of the SLO harness with
     its own mix, hit blend, burst pattern and load trajectory at one
     node's filter (the reference's stacks with n_buckets and wave_slots
     scaled by one factor: 2^20 buckets of 4 and waves of 2^17–2^18 keys,
     half the reference's waves of each scenario but adversarial,
     ``SLO_DEPTH``;
     the ttl ring at 4 generations of 2^22 slots and 2^19-key waves; the
     admission arm at 2^20 buckets, 2^19-key waves); the burst train also
     through the sync and async arms (equal bit for bit); no false
     negatives from the waves' own results; the scenario telemetry mode
     card vs CPU; ``uniform`` once more under a trace for the idle share;
     a ``{"slo": ...}`` JSON line of the rows; launch counts read around
     it;
  5f. one sharded node set at node size (``SHARDED``:
     ``benchmarks/elastic_bench.py``'s settings with 2^20 buckets a shard):
     ``DeferredWritePump`` writes 6,291,456 distinct keys in waves of 2^18
     to load 0.75 (no failure); routed lookups of every key and as many
     absent ones (no false negative, false positives within 4 x the
     theoretical rate); ``ElasticController`` splits to 4 shards (nothing
     lost, every entry on its pair owner, lookups exact) and merges back
     (live entries conserved up to ``failed``); ``save_sharded``, the loss
     of shard 1 (``degraded_lookup`` flags exactly its keys and answers
     them True, the others as before), ``recover_shard`` (every answer
     back); routed deletes of half the keys (all acknowledged, the other
     half still found); then the same writes, lookups and deletes on the
     scan backend; wall and device-busy time of each step, launch counts
     read around it;
  5c. the LM serving path at full size: gemma3-1b (26 layers, full width,
     bfloat16 activations, float32 weights from SEED): a cache-less
     forward over 8192 tokens (prompt scoring, the flash kernel), the
     flash forward against the cached prefill + decode of the same prompt
     (float32, 1024 tokens, log-softmax within 1e-3), ``serve()`` of 16
     requests, and (d) ``ContinuousBatcher``: 8 requests of 1008 + 16
     tokens into 4 slots (tokens equal to ``generate``'s, ``SchedStats``
     equal to the CPU's over a 2-layer model); launch counts read around
     it;
  6. hold each kernel against its plain version at the paths' full size,
     bit for bit, then time it, its plain version and its bound (the
     telemetry instantiations beside their flag-off kernels; for flash
     attention, one ``scaled_dot_product_attention`` call as the library's
     yardstick), and print them as one JSON line; beside them the launch
     floor (the device time of a one-element add), for ``probe_multi``
     the timed call's live stash entries, and ``probe_adaptive`` at the
     adaptive path's launch size too (its 10M benign keys with its stash,
     the same with 128 live stash entries, its remaining members; each
     held against the plain version bit for bit first, then timed by CUDA
     events with L2 flushed before each launch), and ``probe``,
     ``probe_tm`` and ``fingerprint_hash`` at their serving paths' launch
     sizes (PROBE_PATH_SIZES, FINGERPRINT_PATH_SIZES) on phase 5e's node
     table as its ``uniform`` arm leaves it, half the keys held: without
     a stash, with the arm's stash, with its every slot live; each held
     first, then timed warm (the profiler) and with L2 flushed (CUDA
     events), beside its bound, x bound and x the launch floor; and the
     scan kernels at their phase-5f launches (the merge's and the split's
     receive walks, the scan backend's largest insert residue and largest
     delete), held against their plain versions bit for bit, then timed,
     with the time per walked lane, the insert's schedule shares and the
     delete's conflict groups and grouping time; and ``flash_attention`` at
     deepseek-v2-lite's padded MLA shape beside its bound at the unpadded
     heads and one ``scaled_dot_product_attention`` call on them, and at
     phase 5h's five shapes beside their bounds and SDPA;
  5g. (run last, with every earlier phase's state freed) MoE + MLA at
     full size: (a) deepseek-v2-lite-16b (27 layers, full width, float32
     weights from SEED, bfloat16 activations): a cache-less forward over
     8192 tokens, 3 repeats (tokens/s, 27 flash launches, peak memory, the
     device time split into flash, MoE dispatch / combine, other matrix
     products, elementwise and casts; decode steps' kernels); (b) float32:
     the flash forward against a cached prefill (512 + 511 tokens) + one
     decode step at 1024 tokens, log-softmax within 1e-3, at a capacity of
     the whole group, and (b') at the config's capacity the flash forward
     against a cached prefill of the same tokens; (c) ``serve()`` of 8
     requests of 496 + 16 tokens, 8 generated (reused blocks > 0); (d)
     qwen3-moe-235b-a22b at full width, 2 layers: two bfloat16 forwards
     over 4096 tokens (finite, 2 flash launches each); launch counts read
     around it;
  5h. (after 5g, its state freed) mamba2-1.3b, recurrentgemma-2b,
     musicgen-large, llava-next-mistral-7b and nemotron-4-15b at full
     width and depth (float32 weights from SEED, bfloat16 activations):
     (a) a cache-less forward over 8192 positions (llava: 2880 prefix
     embeddings + 5312 tokens; musicgen with a 256-frame memory; nemotron
     at its 4096), 3 repeats: positions/s, flash launches, device busy by
     class, peak memory under 80 GB; (b) float32: the forward against a
     cached prefill of all but the last of 1024 tokens (mamba2: 768 +
     255, its chunk rule) + one decode step, log-softmax within 1e-3,
     with the memory or the prefix; (c) ``serve()`` of mamba2 and
     recurrentgemma, 8 requests of 496 + 16 tokens through the prefix
     index (reused blocks > 0); launch counts read around it.
  5i. (after 5c) training gemma3-1b at full width and depth through
     ``launch.train.train``: 5 steps of 4 x 4096 tokens (train_4k's batch
     of 256 cut to 4), 2 microbatches, remat full, the dedup pipeline on
     the card: finite losses and grad_norms, peak memory, step seconds and
     tokens/s, the flash forward and backward launches per step, no plain
     version; one step under a trace (device busy by class); a run killed
     after a checkpoint resumes to the uninterrupted run's losses.  Phase
     6 then times the backward kernels at the training shapes (B 1 and
     5i's microbatch of 2) beside their bound and SDPA's backward, and
     the forward with and without ``lse`` (at S 4096 beside its bound and
     SDPA's forward).
  5j. (a) ``ContinuousBatcher`` over every cache kind at full width: after
     5g, deepseek-v2-lite-16b (5g's config and seed; an MLA latent cache a
     slot, exact MoE routing at decode), after 5h mamba2-1.3b and
     recurrentgemma-2b (constant-size recurrent caches): 4 requests of 512
     tokens (two share 256) into 2 slots, 6 generated; the tokens equal
     ``generate``'s of each request alone, the prefix index's kernels
     launched; (b) the five filter examples (``examples/torch_*.py``) as
     processes on the card, each rc 0 and its facts read back; (c) the
     dry-run (``repro_torch.launch.dryrun``), a host process a cell,
     started after the build and read here (``DRYRUN_CELLS``): gemma3-1b
     at ``train_4k`` and ``prefill_32k``, recurrentgemma-2b at
     ``train_4k`` and deepseek-v2-lite-16b at ``decode_32k`` on the
     single-pod mesh, gemma3-1b at ``train_4k`` on the multi-pod mesh;
     each cell's OK line and host seconds; beside them the
     model-FLOPs share at 989 TFLOP/s of 5c's 8192-token forward and 5i's
     step (``model_flops_for`` scaled to the tokens run).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
CHUNK = 4096
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# H100 SXM float32 rate outside the tensor cores (data sheet); no higher
# rate is listed for the 32-bit integer operations the kernels do.
SCALAR_OPS_PER_S = 67e12
# H100 SXM dense bfloat16 tensor-core rate (data sheet): the bound of the
# attention kernel's multiply-adds.
TENSOR_OPS_PER_S = 989e12
SECTOR = 32                   # bytes per device-memory sector
# 32-bit operations per key of the fused hash (fingerprint, index_hash and
# alt_index of csrc/ocf_common.cuh, each modulo counted as one).
HASH_OPS = 55
# ... and of the family hash: three more fingerprint_sel of ~24 operations
# each (two murmur3 mixes, the seed tweak, mask and zero remap).
FAMILY_OPS = HASH_OPS + 3 * 24
FULL_BUCKETS = 1 << 22        # 16M slots of 4: the main path's grown size
# The launch sizes of probe and fingerprint_hash on their serving paths:
# the OCF's and the filter-op waves' 4096-key chunks, and the SLO
# scenarios' waves of 2^17-2^19 keys (phase 5e; the insert pre-pass hashes
# a whole wave).
PROBE_PATH_SIZES = (CHUNK, 1 << 17, 1 << 18, 1 << 19)
FINGERPRINT_PATH_SIZES = (CHUNK, 1 << 17, 1 << 18, 1 << 19)
KERNEL_ROWS = {
    # name: (source, TPU kernel it replaces, what holds it back on the card)
    "fingerprint_hash": ("src/repro_torch/csrc/fingerprint.cu",
                         "src/repro/kernels/fingerprint.py:63",
                         "launch_floor"),
    "probe": ("src/repro_torch/csrc/probe.cu",
              "src/repro/kernels/probe.py:122", "random_sector_fetches"),
    "insert_bulk": ("src/repro_torch/csrc/insert.cu",
                    "src/repro/kernels/insert.py:440", "serial_cta_loop"),
    "delete_bulk": ("src/repro_torch/csrc/delete.cu",
                    "src/repro/kernels/delete.py:129", "serial_cta_loop"),
    "fingerprint_hash_family": ("src/repro_torch/csrc/fingerprint_family.cu",
                                "src/repro/kernels/fingerprint.py:119",
                                "not measured"),
    "probe_adaptive": ("src/repro_torch/csrc/probe_adaptive.cu",
                       "src/repro/kernels/probe.py:264",
                       "random_sector_fetches"),
    "insert_bulk_adaptive": ("src/repro_torch/csrc/insert_adaptive.cu",
                             "src/repro/kernels/insert.py:929",
                             "serial_cta_loop"),
    "delete_bulk_adaptive": ("src/repro_torch/csrc/delete_adaptive.cu",
                             "src/repro/kernels/delete.py:245",
                             "serial_cta_loop"),
    "probe_multi": ("src/repro_torch/csrc/probe_multi.cu",
                    "src/repro/kernels/probe.py:403",
                    "bucket_and_stash_latency"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:113",
                        "not measured"),
    # The flash kernel's gradient, for the reference's XLA autodiff of
    # ops.attention in its train step (no pallas_call: its Pallas kernel
    # has no VJP).
    "flash_attention_bwd_pre": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/train/step.py:97",
                                "not measured"),
    "flash_attention_bwd_dkdv": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/train/step.py:97", "cuda_core_float32_products"),
    "flash_attention_bwd_dq": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                               "src/repro/train/step.py:97",
                               "cuda_core_float32_products"),
    # The telemetry instantiations, in place of the reference's twins (its
    # XLA emulations with want_stats, not pallas_call sites).
    "probe_tm": ("src/repro_torch/csrc/probe.cu",
                 "src/repro/kernels/probe.py:156", "random_sector_fetches"),
    "insert_bulk_tm": ("src/repro_torch/csrc/insert.cu",
                       "src/repro/kernels/insert.py:531", "serial_cta_loop"),
    "probe_adaptive_tm": ("src/repro_torch/csrc/probe_adaptive.cu",
                          "src/repro/kernels/probe.py:296",
                          "random_sector_fetches"),
    "insert_bulk_adaptive_tm": ("src/repro_torch/csrc/insert_adaptive.cu",
                                "src/repro/kernels/insert.py:995",
                                "serial_cta_loop"),
    # The scan backend's walks, for the reference's lax.scan cores (no
    # pallas_call): core/filter.py::_insert_one (bulk_insert, :146;
    # distributed/elastic.py::insert_pairs, :125) and bulk_delete's body.
    "scan_insert": ("src/repro_torch/csrc/scan.cu",
                    "src/repro/core/filter.py:77", "serial_cta_loop"),
    "scan_delete": ("src/repro_torch/csrc/scan.cu",
                    "src/repro/core/filter.py:240", "random_sector_fetches"),
}
STATIC_KERNELS = ("fingerprint_hash", "probe", "insert_bulk", "delete_bulk")
ADAPTIVE_KERNELS = ("fingerprint_hash_family", "probe_adaptive",
                    "insert_bulk_adaptive", "delete_bulk_adaptive")
STREAMING_KERNELS = ("probe_multi",)
LM_KERNELS = ("flash_attention",)
LM_ARCH = "gemma3-1b"
LM_SEQ = 8192                 # the prompt-scoring forward of phase 5c
# Phase 5h: the SSM, RG-LRU, cross-attention and prefix architectures and
# nemotron at full width; positions of a cache-less forward (llava: its
# 2880 prefix embeddings + 5312 tokens; nemotron: its max_seq_len, 4096)
ARCH_PATH = ("mamba2-1.3b", "recurrentgemma-2b", "musicgen-large",
             "llava-next-mistral-7b", "nemotron-4-15b")
ARCH_SEQ = 8192
ARCH_CHECK_SEQ = 1024         # 5h (b): float32 forward vs prefill + decode
ARCH_SERVED = ("mamba2-1.3b", "recurrentgemma-2b")
PEAK_BYTES = 80e9             # 5h: the peak device memory allowed
# Phase 3: (layers, tokens) of each at full width, card vs CPU; llava's
# prefix there is ARCH_PARITY_PREFIX embeddings (2880 would cost the CPU
# ~20 s for the same check)
ARCH_PARITY = {"mamba2-1.3b": (2, 256), "recurrentgemma-2b": (3, 256),
               "musicgen-large": (2, 256), "llava-next-mistral-7b": (2, 128),
               "nemotron-4-15b": (2, 128)}
ARCH_PARITY_PREFIX = 128
# Flash attention against its plain version, |got - want| <= tol * (1 +
# |want|): the reference sweep's tolerances (tests/test_kernels.py).
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
# ... and row by row, ||got - want|| / ||want|| over each output row with a
# live key.  On long rows the outputs shrink as 1/sqrt(live keys) (~0.02
# at 8192), so the elementwise form above is about as large as the values
# there; this one is not.  Limits: bfloat16 rounds p and the output (a few
# 1e-3 a row); a kernel that dropped one 64-key tile from a row of n keys
# reads about 8 / sqrt(n), 0.09 at n = 8192 (FlashKernelBench prints it).
FLASH_ROW_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Phases 3 and 5g: the MoE + MLA model (configs/deepseek_v2_lite_16b.py,
# arXiv:2405.04434) and qwen3-moe (configs/qwen3_moe_235b_a22b.py).
MOE_ARCH = "deepseek-v2-lite-16b"
QWEN_ARCH = "qwen3-moe-235b-a22b"
MOE_SEQ = 8192                # 5g (a): 16 routing groups of 512
QWEN_SEQ = 4096
QWEN_LAYERS = 2               # 5g (d): 2 of 94 layers (~25 GB in float32)
# Card against CPU (phase 3, float32): a routing difference is admitted only
# at a near tie, a CPU gate gap at the boundary it crosses of at most this;
# layer outputs row by row within MOE_ROW_TOL (float32 sums in other
# orders, through 2048-wide products), logits within 1e-3, aux within 1e-6.
MOE_NEAR_TIE = 1e-5
MOE_ROW_TOL = 1e-4
# The streaming dedup stage of one node: examples/streaming_dedup.py's ring
# at 2^22 slots a generation (4 x 16 MiB of tables on the card).
RING = dict(generations=4, capacity=1 << 22, bucket_size=4, fp_bits=16,
            stash_slots=128, ttl=24.0, o_max=0.85)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str):
    """Context manager printing a phase's wall time."""
    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== {name}", flush=True)
            return self

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)
            return False
    return _Phase()


def random_keys(rng: np.random.RandomState, n: int) -> np.ndarray:
    return rng.randint(0, 2**63, size=n, dtype=np.int64).astype(np.uint64)


# ------------------------------------------------------- phase 2: kernels --


class KernelBench:
    """Kernel-vs-plain comparisons at main-path shapes on one device."""

    def __init__(self, device, n_buckets: int = FULL_BUCKETS - 256 * 37,
                 buffer: int = FULL_BUCKETS, n_keys: int = CHUNK):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.buffer, self.n_buckets, self.n_keys = buffer, n_buckets, n_keys
        self.rng = np.random.RandomState(SEED)
        self.max_err = {}

    def synthetic_table(self, load: float):
        """A buffer filled to ``load`` with random nonzero fingerprints."""
        torch = self.torch
        fill = self.rng.rand(self.buffer, 4) < load
        fps = self.rng.randint(1, 1 << 16, size=(self.buffer, 4))
        table = np.where(fill, fps, 0).astype(np.int32)
        table[self.n_buckets:] = 0
        return torch.from_numpy(table).to(self.dev)

    def keys(self):
        from repro_torch.core import hashing
        k = random_keys(self.rng, self.n_keys)
        hi, lo = hashing.key_to_u32_pair_np(k)
        t = self.torch
        return (k, t.from_numpy(hi.view(np.int32)).to(self.dev),
                t.from_numpy(lo.view(np.int32)).to(self.dev))

    def record(self, name: str, pairs) -> None:
        torch = self.torch
        err = 0
        for a, b in pairs:
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name}: kernel and plain outputs differ in shape/dtype")
            d = (a.to(torch.int64) - b.to(torch.int64)).abs()
            err = max(err, int(d.max()) if d.numel() else 0)
        check(err == 0, f"{name}: kernel differs from its plain version "
                        f"(max abs err {err})")
        self.max_err[name] = max(self.max_err.get(name, 0), err)

    def plain_insert(self, table, hi, lo, valid, *, stash, rounds, block,
                     schedule):
        """The plain insert with stats -> (ok, counter plane)."""
        from repro_torch.core.scheduling import dispatch_order_from_buckets
        from repro_torch.kernels.fingerprint import fingerprint_hash_plain
        from repro_torch.kernels.insert import insert_bulk_plain
        from repro_torch.kernels.telemetry import insert_plane
        inv = None
        if schedule and hi.shape[0] > block:
            _fp, i1, _i2 = fingerprint_hash_plain(
                hi, lo, fp_bits=16, n_buckets=self.n_buckets)
            perm, inv = dispatch_order_from_buckets(i1, valid)
            hi, lo, valid = hi[perm], lo[perm], valid[perm]
        ok, stats = insert_bulk_plain(table, hi, lo, valid, fp_bits=16,
                                      n_buckets=self.n_buckets,
                                      evict_rounds=rounds, stash=stash,
                                      block=block, want_stats=True)
        plane = insert_plane(*stats, valid)
        return (ok if inv is None else ok[inv]), plane

    def hold_tm(self, name: str, got, want, off_pairs) -> None:
        """A telemetry instantiation against its plain version with stats
        (``got`` and ``want``: (outputs, plane)) and against the flag-off
        kernel (``off_pairs``: its outputs beside the twin's)."""
        self.record(name, [*zip(got[0], want[0]), (got[1], want[1]),
                           *off_pairs])

    def run(self) -> None:
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
        from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                     fingerprint_hash_plain)
        from repro_torch.kernels.insert import insert_bulk, insert_bulk_tm
        from repro_torch.kernels.probe import probe, probe_plain, probe_tm

        nb = self.n_buckets
        # fingerprint_hash at a chunk, non-pow2 active count.
        _k, hi, lo = self.keys()
        self.record("fingerprint_hash", zip(
            fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb),
            fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)))

        # probe on a 0.85-load full-size table, half the keys planted.
        table = self.synthetic_table(0.85)
        keys, hi, lo = self.keys()
        half = keys[: keys.size // 2]
        h_hi, h_lo = hashing.key_to_u32_pair_np(half)
        fp = hashing.fingerprint_np(h_hi, h_lo, 16).astype(np.int64)
        i1 = hashing.index_hash_np(h_hi, h_lo, nb).astype(np.int64)
        table[torch.from_numpy(i1).to(self.dev), 0] = \
            torch.from_numpy(fp).to(self.dev).to(torch.int32)
        stash = torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
        stash[0, :64] = torch.from_numpy(fp[:64]).to(self.dev).int()
        stash[1, :64] = torch.from_numpy(
            hashing.alt_index_np(i1[:64], fp[:64], nb).astype(np.int64)
        ).to(self.dev).int()
        pblock = min(kops.autotune_block("probe", table_bytes=table.numel() * 4),
                     CHUNK)
        for st in (None, stash):
            got = probe(table, hi, lo, fp_bits=16, n_buckets=nb, stash=st,
                        block=pblock)
            want = probe_plain(table, hi, lo, fp_bits=16, n_buckets=nb,
                               stash=st)
            self.record("probe", [(got, want)])
            # the telemetry twin, the last 100 lanes uncounted
            self.hold_probe_tm("probe_tm", probe_tm, probe_plain, got,
                               (table, hi, lo), CHUNK - 100, pblock,
                               dict(fp_bits=16, n_buckets=nb, stash=st))
            _u, inv, cnt = np.unique(i1, return_inverse=True,
                                     return_counts=True)
            sole = torch.from_numpy(cnt[inv] == 1).to(self.dev)
            check(bool(got[: half.size][sole].all()), "probe missed a key")

        # insert: uncontended, 0.9-load eviction storms (a tight budget of
        # 8 rounds) with rollback and with a stash, and the schedule
        # pre-pass.
        cases = [("uncontended", 0.5, 32, False, False),
                 ("storm+rollback", 0.9, 8, False, False),
                 ("storm+stash", 0.9, 8, True, False),
                 ("schedule", 0.85, 32, False, True)]
        for label, load, rounds, with_stash, schedule in cases:
            base = self.synthetic_table(load)
            _k, hi, lo = self.keys()
            valid = torch.from_numpy(self.rng.rand(self.n_keys) < 0.97
                                     ).to(self.dev)
            block = min(kops.autotune_block(
                "insert", table_bytes=base.numel() * 4, evict_rounds=rounds,
                stash_slots=128 if with_stash else 0, n_keys=CHUNK), CHUNK)
            tk, tp, tt = base.clone(), base.clone(), base.clone()
            sk = (torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
                  if with_stash else None)
            sp = None if sk is None else sk.clone()
            st = None if sk is None else sk.clone()
            kw = dict(fp_bits=16, n_buckets=nb, valid=valid,
                      evict_rounds=rounds, block=block, schedule=schedule)
            out = insert_bulk(tk, hi, lo, stash=sk, **kw)
            okp, plane = self.plain_insert(tp, hi, lo, valid, stash=sp,
                                           rounds=rounds, block=block,
                                           schedule=schedule)
            pairs = [(tk, tp), (out[-1], okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk", pairs)
            tm = insert_bulk_tm(tt, hi, lo, stash=st, **kw)
            self.hold_tm("insert_bulk_tm", ([tt, tm[-2]], tm[-1]),
                         ([tp, okp], plane),
                         [(tt, tk), (tm[-2], out[-1])]
                         + ([] if sk is None else [(st, sk)]))
            failed = int((valid & ~okp).sum())
            spilled = 0 if sp is None else int((sp[0] != 0).sum())
            print(f"   insert {label}: block={block} rounds={rounds} "
                  f"failed={failed} stashed={spilled}", flush=True)
            if label == "storm+rollback":
                check(failed > 0, "the storm case rolled nothing back")
            if label == "storm+stash":
                check(spilled > 0, "the stash case spilled nothing")

        # delete with duplicates, from a table holding the keys.
        base = self.synthetic_table(0.5)
        keys, hi, lo = self.keys()
        valid = torch.ones(self.n_keys, dtype=torch.bool, device=self.dev)
        _t, ins_ok = insert_bulk(base, hi, lo, fp_bits=16, n_buckets=nb,
                                 valid=valid, evict_rounds=32, block=128)
        dup = np.concatenate([keys[: CHUNK // 2], keys[: CHUNK // 4],
                              keys[: CHUNK // 4]])
        d_hi, d_lo = hashing.key_to_u32_pair_np(dup)
        d_hi = torch.from_numpy(d_hi.view(np.int32)).to(self.dev)
        d_lo = torch.from_numpy(d_lo.view(np.int32)).to(self.dev)
        dblock = min(kops.autotune_block(
            "delete", table_bytes=base.numel() * 4, n_keys=CHUNK), CHUNK)
        tk, tp = base.clone(), base.clone()
        _t, okk = delete_bulk(tk, d_hi, d_lo, fp_bits=16, n_buckets=nb,
                              valid=valid, block=dblock)
        okp = delete_bulk_plain(tp, d_hi, d_lo, valid, fp_bits=16,
                                n_buckets=nb, block=dblock)
        self.record("delete_bulk", [(tk, tp), (okk, okp)])
        first = slice(0, CHUNK // 2)
        check(bool(okk[first][ins_ok[first]].all()),
              "delete missed a resident key")
        self.staging()
        self.probe_cases()
        self.fingerprint_cases()

    def hold_probe_tm(self, name, kern_tm, plain, off, args, counted, block,
                      kw) -> list:
        """A probe's telemetry twin against the plain version with stats
        (answers and the depth plane of the first ``counted`` lanes) and
        against the flag-off kernel's answers ``off`` -> the plane."""
        torch = self.torch
        from repro_torch.kernels.telemetry import probe_depth_counts
        hit, plane = kern_tm(*args, n_valid=counted, block=block, **kw)
        want, hs = plain(*args, want_stats=True, **kw)
        n = want.shape[0]
        mask = torch.arange(n, device=self.dev) < counted
        self.record(name, [(hit, want), (plane, probe_depth_counts(*hs,
                                                                   mask)),
                           (hit, off)])
        return plane.tolist()

    def probe_cases(self) -> None:
        """PROBE_CASES, with and without their stash: probe's telemetry
        twin against the plain version with stats and the flag-off
        kernel (padding key 0 planted after the counted lanes)."""
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import probe, probe_plain, probe_tm
        from repro_torch.kernels.staging_cases import (PROBE_CASES,
                                                       probe_inputs)
        torch = self.torch

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_CASES:
            c = probe_inputs(label, SEED)
            table = dev32(c["table"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            planes = []
            for st in (None, None if c["stash"] is None
                       else dev32(c["stash"])):
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stash=st)
                off = probe(table, hi, lo, block=c["block"], **kw)
                self.record("probe", [(off, probe_plain(table, hi, lo,
                                                        **kw))])
                planes.append(self.hold_probe_tm(
                    "probe_tm", probe_tm, probe_plain, off, (table, hi, lo),
                    c["counted"], c["block"], kw))
            print(f"   probe case {label}: n={c['keys'].size} counted="
                  f"{c['counted']} depth planes without / with the stash="
                  f"{planes}: same as the plain version", flush=True)

    def fingerprint_cases(self) -> None:
        """FINGERPRINT_CASES: fingerprint_hash at small and ragged n up to
        the serving paths' largest launches, on views aligned and one
        element into their storage, kernel against the plain version."""
        from repro_torch.core import hashing
        from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                     fingerprint_hash_plain)
        from repro_torch.kernels.staging_cases import FINGERPRINT_CASES
        torch = self.torch
        for n, offset in FINGERPRINT_CASES:
            keys = random_keys(self.rng, n + offset)
            hi, lo = (torch.from_numpy(x.view(np.int32)).to(self.dev)[offset:]
                      for x in hashing.key_to_u32_pair_np(keys))
            nb = self.n_buckets - n
            got = fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb, block=n)
            want = fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)
            self.record("fingerprint_hash", zip(got, want))
            print(f"   fingerprint_hash case n={n} offset={offset} "
                  f"(16-byte aligned: {hi.data_ptr() % 16 == 0}): same as "
                  f"the plain version", flush=True)

    def staging(self) -> None:
        """STAGING_CASES: insert (the first quarter of the keys twice, in
        other blocks), then delete (the first half, then the first quarter
        twice more: the k-th repeat clears the k-th copy), kernel against
        plain version on the same table, stash and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
        from repro_torch.kernels.insert import (insert_bulk,
                                                insert_bulk_plain,
                                                insert_bulk_tm)
        from repro_torch.kernels.staging_cases import (STAGING_CASES,
                                                       staging_inputs)
        from repro_torch.kernels.telemetry import insert_plane

        def dev32(a):
            return torch.from_numpy(a.astype(np.uint32).view(np.int32)
                                    ).to(self.dev)

        for label in STAGING_CASES:
            c = staging_inputs(label, SEED)
            nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
            sk = None if c["stash"] is None else dev32(c["stash"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(
                c["keys"]))
            valid = torch.from_numpy(c["valid"]).to(self.dev)
            tk = dev32(c["table"])
            tp, sp = tk.clone(), None if sk is None else sk.clone()
            tt, st = tk.clone(), None if sk is None else sk.clone()
            okk = insert_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb,
                              valid=valid, evict_rounds=rounds, stash=sk,
                              block=block)[-1]
            okp, stats = insert_bulk_plain(tp, hi, lo, valid, fp_bits=16,
                                           n_buckets=nb, evict_rounds=rounds,
                                           stash=sp, block=block,
                                           want_stats=True)
            pairs = [(tk, tp), (okk, okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk", pairs)
            tm = insert_bulk_tm(tt, hi, lo, fp_bits=16, n_buckets=nb,
                                valid=valid, evict_rounds=rounds, stash=st,
                                block=block)
            plane = insert_plane(*stats, valid)
            self.hold_tm("insert_bulk_tm", ([tt, tm[-2]], tm[-1]),
                         ([tp, okp], plane),
                         [(tt, tk), (tm[-2], okk)]
                         + ([] if sk is None else [(st, sk)]))
            dele = c["delete"]
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(dele))
            every = torch.ones(dele.size, dtype=torch.bool, device=self.dev)
            _t, dk = delete_bulk(tk, hi, lo, fp_bits=16, n_buckets=nb,
                                 valid=every, block=block)
            dp = delete_bulk_plain(tp, hi, lo, every, fp_bits=16,
                                   n_buckets=nb, block=block)
            self.record("delete_bulk", [(tk, tp), (dk, dp)])
            failed = int((valid & ~okp).sum())
            slots = 0 if sp is None else sp.shape[1]
            print(f"   staging {label}: block={block} rounds={rounds} "
                  f"bucket_size={tk.shape[1]} keys={c['keys'].size} "
                  f"failed={failed} stashed="
                  f"{0 if sp is None else int((sp[0] != 0).sum())}/{slots} "
                  f"deleted={int(dp.sum())} of {dele.size}; telemetry "
                  f"twin's plane {plane.tolist()} same as the plain "
                  f"version's", flush=True)
            check(failed > 0, f"staging {label}: no insert failed")


class AdaptiveKernelBench(KernelBench):
    """The four adaptive kernels against their plain versions on a
    four-plane state of main-path size with nonzero selectors."""

    def adaptive_state(self, load: float, sel_share: float = 0.25):
        """Keys placed in their home buckets up to ``load`` of the active
        region; a ``sel_share`` of the occupied slots on a nonzero selector
        with the fingerprint rewritten under it -> [table, sels, khi, klo]
        int32 tensors on the card, and the resident keys' (hi, lo)."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.core.scheduling import conflict_waves
        from repro_torch.kernels.selector import sel_pack
        nb, buf, dev = self.n_buckets, self.buffer, self.dev
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.rng.randint(1 << 30)))
        n = int(nb * 4 * load * 2.5)
        keys = torch.randint(-2 ** 31, 2 ** 31, (2, n), dtype=torch.int32,
                             device=dev, generator=gen)
        home = hashing.index_hash(keys[0], keys[1], nb)
        rank = conflict_waves(home, torch.ones_like(home, dtype=torch.bool))
        take = torch.nonzero(rank < 4).flatten()[: int(nb * 4 * load)]
        b, s = home[take], rank[take]
        khi = torch.zeros((buf, 4), dtype=torch.int32, device=dev)
        klo = torch.zeros_like(khi)
        khi[b, s], klo[b, s] = keys[0, take], keys[1, take]
        sel = torch.zeros((buf, 4), dtype=torch.int64, device=dev)
        adapt = torch.rand(take.numel(), generator=gen, device=dev) < sel_share
        sel[b[adapt], s[adapt]] = torch.randint(
            1, 4, (int(adapt.sum()),), generator=gen, device=dev)
        table = torch.zeros_like(khi)
        table[b, s] = hashing.to_i32(hashing.fingerprint_sel(
            khi[b, s], klo[b, s], sel[b, s], 16))
        return [table, sel_pack(sel), khi, klo], (keys[0, take],
                                                  keys[1, take])

    @staticmethod
    def adapted_slots(planes) -> int:
        from repro_torch.kernels.selector import sel_unpack
        return int(((planes[0] != 0) &
                    (sel_unpack(planes[1], planes[0].shape[1]) != 0)).sum())

    def run(self) -> None:
        torch = self.torch
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                                delete_bulk_adaptive_plain)
        from repro_torch.kernels.fingerprint import (
            fingerprint_hash, fingerprint_hash_family,
            fingerprint_hash_family_plain)
        from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                                insert_bulk_adaptive_plain)
        from repro_torch.kernels.probe import (probe, probe_adaptive,
                                               probe_adaptive_plain)

        nb = self.n_buckets
        _k, hi, lo = self.keys()
        fam, i1, i2 = fingerprint_hash_family(hi, lo, fp_bits=16,
                                              n_buckets=nb)
        p_fam, p_i1, p_i2 = fingerprint_hash_family_plain(
            hi, lo, fp_bits=16, n_buckets=nb)
        self.record("fingerprint_hash_family",
                    zip((*fam, i1, i2), (*p_fam, p_i1, p_i2)))
        static = fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb)
        check(all(torch.equal(a, b) for a, b in zip((fam[0], i1, i2),
                                                     static)),
              "the family's (f0, i1, i2) differ from fingerprint_hash")

        # With an all-zero selector plane the adaptive probe is the probe.
        table = self.synthetic_table(0.85)
        zero = torch.zeros((self.buffer, 1), dtype=torch.int32,
                           device=self.dev)
        stash = torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
        stash[0, :64] = torch.arange(1, 65, device=self.dev)
        stash[1, :64] = i2[:64]
        for st in (None, stash):
            check(torch.equal(
                probe_adaptive(table, zero, hi, lo, fp_bits=16, n_buckets=nb,
                               stash=st),
                probe(table, hi, lo, fp_bits=16, n_buckets=nb, stash=st)),
                "probe_adaptive on a zero selector plane differs from probe")

        # insert: (load, evict_rounds, stash, what it must reach).
        cases = [("uncontended", 0.5, 32, False, set()),
                 ("optimistic+spill", 0.85, 0, True, {"spill"}),
                 ("storm+rollback", 0.95, 8, True,
                  {"kick", "spill", "rollback"}),
                 ("storm", 0.95, 32, True, {"kick", "spill"})]
        storm = None
        for label, load, rounds, with_stash, must in cases:
            base, (m_hi, m_lo) = self.adaptive_state(load)
            _k, hi, lo = self.keys()
            valid = torch.from_numpy(self.rng.rand(self.n_keys) < 0.97
                                     ).to(self.dev)
            block = min(kops.autotune_block(
                "insert", table_bytes=kops._adaptive_plane_bytes(base[0]),
                evict_rounds=2 * rounds,
                stash_slots=128 if with_stash else 0, n_keys=CHUNK), CHUNK)
            pk = [p.clone() for p in base]
            pp = [p.clone() for p in base]
            sk = (torch.zeros((2, 128), dtype=torch.int32, device=self.dev)
                  if with_stash else None)
            sp = None if sk is None else sk.clone()
            out = insert_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                       valid=valid, evict_rounds=rounds,
                                       stash=sk, block=block)
            okp = insert_bulk_adaptive_plain(*pp, hi, lo, valid, fp_bits=16,
                                             n_buckets=nb,
                                             evict_rounds=rounds, stash=sp,
                                             block=block)
            pairs = list(zip(pk, pp)) + [(out[-1], okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk_adaptive", pairs)
            failed = int((valid & ~okp).sum())
            spilled = 0 if sp is None else int((sp[0] != 0).sum())
            reset = self.adapted_slots(base) - self.adapted_slots(pp)
            print(f"   insert_adaptive {label}: block={block} "
                  f"rounds={rounds} failed={failed} stashed={spilled} "
                  f"adapted slots reset by kicks={reset}", flush=True)
            reached = {name for name, hit in (("kick", reset > 0),
                                              ("spill", spilled > 0),
                                              ("rollback", failed > 0))
                       if hit}
            check(must <= reached, f"insert case {label} reached {reached}, "
                                   f"not {must}")
            if label == "storm+rollback":
                storm = pk, sk, (m_hi, m_lo), (hi, lo, okp)

        # probe and delete on the storm's state: members, landed keys,
        # absent keys; deletes with duplicates.
        planes, stash, (m_hi, m_lo), (n_hi, n_lo, okp) = storm
        half = CHUNK // 2
        _k, a_hi, a_lo = self.keys()
        p_hi = torch.cat([m_hi[:half // 2], n_hi[okp][:half // 2],
                          a_hi[:half]])
        p_lo = torch.cat([m_lo[:half // 2], n_lo[okp][:half // 2],
                          a_lo[:half]])
        pblock = min(kops.autotune_block(
            "probe", table_bytes=kops._adaptive_plane_bytes(planes[0]),
            stash_slots=128), CHUNK)
        for st in (None, stash):
            got = probe_adaptive(planes[0], planes[1], p_hi, p_lo,
                                 fp_bits=16, n_buckets=nb, stash=st,
                                 block=pblock)
            want = probe_adaptive_plain(planes[0], planes[1], p_hi, p_lo,
                                        fp_bits=16, n_buckets=nb, stash=st)
            self.record("probe_adaptive", [(got, want)])
        check(bool(got[:p_hi.numel() - half].all()),
              "probe_adaptive missed a member")
        d_hi = torch.cat([m_hi[:half], m_hi[:half // 2], m_hi[:half // 2]])
        d_lo = torch.cat([m_lo[:half], m_lo[:half // 2], m_lo[:half // 2]])
        valid = torch.ones(CHUNK, dtype=torch.bool, device=self.dev)
        dblock = min(kops.autotune_block(
            "delete", table_bytes=kops._adaptive_plane_bytes(planes[0]),
            n_keys=CHUNK), CHUNK)
        pk = [p.clone() for p in planes]
        pp = [p.clone() for p in planes]
        okk = delete_bulk_adaptive(*pk, d_hi, d_lo, fp_bits=16, n_buckets=nb,
                                   valid=valid, block=dblock)[-1]
        okd = delete_bulk_adaptive_plain(*pp, d_hi, d_lo, valid, fp_bits=16,
                                         n_buckets=nb, block=dblock)
        self.record("delete_bulk_adaptive",
                    list(zip(pk, pp)) + [(okk, okd)])
        print(f"   delete_adaptive: block={dblock} cleared={int(okd.sum())} "
              f"of {CHUNK} (duplicates past the resident copy miss)",
              flush=True)
        self.staging()
        self.cases()

    def staging(self) -> None:
        """ADAPTIVE_STAGING_CASES: insert, then delete (with repeats and
        residents), kernel against plain version on copies of the same
        planes, stash and keys; then the tiny table again with its calls
        split into launches of at most 300 keys (two logical blocks)."""
        torch = self.torch
        from repro_torch.kernels import cuda
        from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                                delete_bulk_adaptive_plain)
        from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                                insert_bulk_adaptive_plain,
                                                insert_bulk_adaptive_tm)
        from repro_torch.kernels.staging_cases import (
            ADAPTIVE_STAGING_CASES, adaptive_staging_inputs)
        from repro_torch.kernels.telemetry import insert_plane
        from repro_torch.core import hashing

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        def one(label, split_keys=cuda.SPLIT_KEYS):
            c = adaptive_staging_inputs(label, SEED)
            nb, block, rounds = c["n_buckets"], c["block"], c["rounds"]
            pk = [dev32(p) for p in c["planes"]]
            pp = [p.clone() for p in pk]
            pt = [p.clone() for p in pk]
            sk = None if c["stash"] is None else dev32(c["stash"])
            sp = None if sk is None else sk.clone()
            st = None if sk is None else sk.clone()
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            valid = torch.from_numpy(c["valid"]).to(self.dev)
            before = self.adapted_slots(pk)
            okk = insert_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                       valid=valid, evict_rounds=rounds,
                                       stash=sk, block=block,
                                       split_keys=split_keys)[-1]
            okp, stats = insert_bulk_adaptive_plain(
                *pp, hi, lo, valid, fp_bits=16, n_buckets=nb,
                evict_rounds=rounds, stash=sp, block=block, want_stats=True)
            pairs = list(zip(pk, pp)) + [(okk, okp)]
            if sk is not None:
                pairs.append((sk, sp))
            self.record("insert_bulk_adaptive", pairs)
            tm = insert_bulk_adaptive_tm(*pt, hi, lo, fp_bits=16,
                                         n_buckets=nb, valid=valid,
                                         evict_rounds=rounds, stash=st,
                                         block=block, split_keys=split_keys)
            self.hold_tm("insert_bulk_adaptive_tm",
                         ([*pt, tm[-2]], tm[-1]),
                         ([*pp, okp], insert_plane(*stats, valid)),
                         [*zip(pt, pk), (tm[-2], okk)]
                         + ([] if sk is None else [(st, sk)]))
            failed = int((valid & ~okp).sum())
            reset = before - self.adapted_slots(pp)
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(
                c["delete"]))
            every = torch.ones(c["delete"].size, dtype=torch.bool,
                               device=self.dev)
            dk = delete_bulk_adaptive(*pk, hi, lo, fp_bits=16, n_buckets=nb,
                                      valid=every, block=block,
                                      split_keys=split_keys)[-1]
            dp = delete_bulk_adaptive_plain(*pp, hi, lo, every, fp_bits=16,
                                            n_buckets=nb, block=block)
            self.record("delete_bulk_adaptive",
                        list(zip(pk, pp)) + [(dk, dp)])
            return failed, reset, sp, int(dp.sum()), c

        for label in ADAPTIVE_STAGING_CASES:
            failed, reset, sp, deleted, c = one(label)
            print(f"   adaptive staging {label}: block={c['block']} rounds="
                  f"{c['rounds']} bucket_size={c['planes'][0].shape[1]} "
                  f"keys={c['keys'].size} failed={failed} adapted slots "
                  f"reset by kept kicks={reset} stashed="
                  f"{0 if sp is None else int((sp[0] != 0).sum())} "
                  f"deleted={deleted} of {c['delete'].size}", flush=True)
            check(failed > 0, f"adaptive staging {label}: no insert failed")
        before = cuda.LAUNCHES["insert_bulk_adaptive"]
        one("tiny-table", split_keys=300)
        n_launch = cuda.LAUNCHES["insert_bulk_adaptive"] - before
        check(n_launch == 4, f"a split call made {n_launch} launches, not 4")
        print(f"   adaptive staging tiny-table split into {n_launch} "
              f"launches: same as the plain version", flush=True)

    def cases(self) -> None:
        """PROBE_ADAPTIVE_CASES, with and without the stash: kernel against
        plain version on the same planes, stash and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import (probe_adaptive,
                                               probe_adaptive_plain,
                                               probe_adaptive_tm)
        from repro_torch.kernels.staging_cases import (
            PROBE_ADAPTIVE_CASES, probe_adaptive_inputs)

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_ADAPTIVE_CASES:
            c = probe_adaptive_inputs(label, SEED)
            table, sels = dev32(c["table"]), dev32(c["sels"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            hits, planes = [], []
            for st in (None, dev32(c["stash"])):
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stash=st)
                got = probe_adaptive(table, sels, hi, lo, block=c["block"],
                                     **kw)
                want = probe_adaptive_plain(table, sels, hi, lo, **kw)
                self.record("probe_adaptive", [(got, want)])
                hits.append(int(got.sum()))
                # the telemetry twin, the last 7 lanes uncounted
                planes.append(self.hold_probe_tm(
                    "probe_adaptive_tm", probe_adaptive_tm,
                    probe_adaptive_plain, got, (table, sels, hi, lo),
                    max(0, c["keys"].size - 7), c["block"], kw))
            print(f"   probe_adaptive case {label}: bucket_size="
                  f"{c['table'].shape[1]} fp_bits={c['fp_bits']} n="
                  f"{c['keys'].size} stash slots={c['stash'].shape[1]} live="
                  f"{int((c['stash'][0] != 0).sum())} hits without / with "
                  f"the stash={hits}, depth planes={planes}: same as the "
                  f"plain version", flush=True)


class StreamingKernelBench(KernelBench):
    """probe_multi against its plain version at the ring's shape: K = 1, 2,
    4 of four generation tables int32[4, 2^20, 4] filled by the insert
    kernel to loads 0.25 .. 0.9 (spills in their int32[2, 128] stashes),
    with and without the stashes, once with n_buckets == buffer (the
    ring's case) and once below it; 4096-key chunks half present, half
    absent."""

    def __init__(self, device):
        buf = RING["capacity"] // RING["bucket_size"]
        super().__init__(device, n_buckets=buf, buffer=buf)

    def generations(self, nb: int, loads):
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.insert import insert_bulk
        k = len(loads)
        tables = torch.zeros((k, self.buffer, 4), dtype=torch.int32,
                             device=self.dev)
        stashes = torch.zeros((k, 2, 128), dtype=torch.int32,
                              device=self.dev)
        landed = []
        for g, load in enumerate(loads):
            keys = random_keys(self.rng, int(nb * 4 * load) // 128 * 128)
            hi, lo = (torch.from_numpy(x.view(np.int32)).to(self.dev)
                      for x in hashing.key_to_u32_pair_np(keys))
            ok = insert_bulk(tables[g], hi, lo, fp_bits=16, n_buckets=nb,
                             evict_rounds=16, stash=stashes[g], block=128)[-1]
            landed.append(keys[ok.cpu().numpy()])
        return tables, stashes, landed

    def run(self) -> None:
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels.probe import probe_multi, probe_multi_plain

        half = CHUNK // 2
        pblock = min(kops.autotune_block(
            "probe", table_bytes=self.buffer * 4 * 4, stash_slots=128), CHUNK)
        for nb in (self.buffer, self.buffer - self.buffer // 100):
            tables, stashes, landed = self.generations(
                nb, (0.25, 0.5, 0.75, 0.9))
            spilled = [int((s[0] != 0).sum()) for s in stashes]
            check(spilled[-1] > 0, "the 0.9-load generation spilled nothing")
            for k in (1, 2, 4):
                pool = np.concatenate(landed[:k])
                keys = np.concatenate([
                    pool[self.rng.randint(0, pool.size, half)],
                    random_keys(self.rng, half)])
                hi, lo = (torch.from_numpy(x.view(np.int32)).to(self.dev)
                          for x in hashing.key_to_u32_pair_np(keys))
                for st in (None, stashes[:k]):
                    got = probe_multi(tables[:k], hi, lo, fp_bits=16,
                                      n_buckets=nb, stashes=st, block=pblock)
                    want = probe_multi_plain(tables[:k], hi, lo, fp_bits=16,
                                             n_buckets=nb, stashes=st)
                    self.record("probe_multi", [(got, want)])
                check(bool(got[:half].all()), "probe_multi missed a key")
                # The ring's launch: the pool's live slots, in any order.
                gens = list(range(k - 1, -1, -1))
                got = probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                  stashes=stashes, gens=gens, block=pblock)
                want = probe_multi_plain(tables, hi, lo, fp_bits=16,
                                         n_buckets=nb, stashes=stashes,
                                         gens=gens)
                self.record("probe_multi", [(got, want)])
                check(bool(got[:half].all()), "probe_multi missed a key")
                print(f"   probe_multi n_buckets={nb} K={k}: hits "
                      f"{int(got[:half].sum())} of {half} present, "
                      f"{int(got[half:].sum())} of {half} absent; stash "
                      f"entries {spilled[:k]}", flush=True)
        # More pool slots than the kernel's 64-bit live mask (one launch per
        # 64 slots holding a generation to probe): the four generations
        # repeated into pools of 65 and 130 slots.
        for k in (65, 130):
            pick = torch.arange(k, device=self.dev) % 4
            big, big_st = tables[pick], stashes[pick]
            hits = []
            for gens in (None, [0, 63, 64, k - 1]):
                for st in (None, big_st):
                    got = probe_multi(big, hi, lo, fp_bits=16, n_buckets=nb,
                                      stashes=st, gens=gens, block=pblock)
                    want = probe_multi_plain(big, hi, lo, fp_bits=16,
                                             n_buckets=nb, stashes=st,
                                             gens=gens)
                    self.record("probe_multi", [(got, want)])
                    hits.append(int(got[:half].sum()))
            # Every slot live, with the stashes: all four generations.
            check(hits[1] == half, "probe_multi missed a key")
            print(f"   probe_multi K={k}: hits of {half} present {hits} "
                  f"(all slots without / with stashes, then slots 0, 63, "
                  f"64, K - 1: generations 0 and 3)", flush=True)
        self.cases()

    def cases(self) -> None:
        """PROBE_MULTI_CASES, with and without the stashes: kernel against
        plain version on the same tables, stashes, live slots and keys."""
        torch = self.torch
        from repro_torch.core import hashing
        from repro_torch.kernels.probe import probe_multi, probe_multi_plain
        from repro_torch.kernels.staging_cases import (PROBE_MULTI_CASES,
                                                       probe_multi_inputs)

        def dev32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                    .view(np.int32)).to(self.dev)

        for label in PROBE_MULTI_CASES:
            c = probe_multi_inputs(label, SEED)
            tables = dev32(c["tables"])
            hi, lo = (dev32(x) for x in hashing.key_to_u32_pair_np(c["keys"]))
            sts = [None] + ([] if c["stashes"] is None
                            else [dev32(c["stashes"])])
            for st in sts:
                kw = dict(fp_bits=c["fp_bits"], n_buckets=c["n_buckets"],
                          stashes=st, gens=c["gens"])
                got = probe_multi(tables, hi, lo, block=c["block"], **kw)
                want = probe_multi_plain(tables, hi, lo, **kw)
                self.record("probe_multi", [(got, want)])
            live = (range(c["tables"].shape[0]) if c["gens"] is None
                    else c["gens"])
            entries = (0 if c["stashes"] is None
                       else int((c["stashes"][list(live), 0] != 0).sum()))
            print(f"   probe_multi case {label}: K={c['tables'].shape[0]} "
                  f"live={len(live)} bucket_size={c['tables'].shape[2]} "
                  f"fp_bits={c['fp_bits']} n={c['keys'].size} live stash "
                  f"entries={entries} hits={int(got.sum())}: same as the "
                  f"plain version", flush=True)


def row_rel_err(got, want):
    """Per output row (the last axis) ||got - want|| / ||want|| over the
    rows whose ``want`` is not all 0 -> a float tensor of those rows."""
    num = (got.float() - want.float()).norm(dim=-1)
    den = want.float().norm(dim=-1)
    live = den > 0
    return num[live] / den[live]


class FlashKernelBench:
    """flash_attention against its plain version on the card: gemma3-1b's
    heads at the prompt-scoring length (global and 512-window layers, both
    dtypes), small cases of the reference's sweep (soft-cap 30,
    non-causal, decode-style Sq = 1, D of 16 to 128), Sq > Skv, whose
    first rows have no live key and must be 0, and lengths that cut the
    kernel's 128-row q tile and 64-key kv tile short.  STRIDED_CASES pass
    q as a [B, S, Hq, D] tensor seen as [B, Hq, S, D] and k, v as slices
    of one packed [B, S, 2, Hkv, D] tensor (Hkv > 1, so no stride is
    dense), held against the plain version on contiguous copies.  Each
    case is held elementwise (FLASH_TOL) and row by row (FLASH_ROW_TOL);
    on the long global case the script also reads what the row check
    would see from a kernel that dropped the first 64-key tile of every
    row (the plain version without those keys) and requires the check to
    catch it.  PATH_CASES, in bfloat16 only, are the shapes of phase 5h's
    forwards."""

    CASES = [
        # b, hq, hkv, sq, skv, d, causal, window, softcap
        (1, 4, 1, LM_SEQ, LM_SEQ, 256, True, 512, None),
        (1, 4, 1, LM_SEQ, LM_SEQ, 256, True, None, None),
        (2, 4, 2, 128, 128, 64, True, None, None),
        (1, 8, 1, 256, 256, 64, True, 64, None),
        (2, 2, 2, 128, 256, 128, True, None, 30.0),
        (1, 4, 4, 1, 384, 64, True, None, None),
        (1, 2, 1, 128, 128, 32, False, None, None),
        (1, 4, 1, 256, 256, 16, True, 16, None),
        (1, 2, 1, 256, 128, 32, True, None, None),
        # the bfloat16 kernel's 128-row q tile and 64-key kv tile cut short
        (1, 2, 2, 72, 72, 64, True, None, None),
        (1, 4, 2, 1, 72, 128, True, None, None),
        (1, 4, 1, 96, 96, 256, True, 1, None),
        # lengths that are no multiple of the tiles: ragged last q and kv
        # tiles (gemma3-1b heads at S = 200, global and windowed)
        (1, 4, 1, 200, 200, 256, True, None, None),
        (1, 4, 1, 200, 200, 256, True, 64, None),
        (1, 2, 1, 300, 300, 64, True, None, 20.0),
    ]
    # the shapes phase 5h's cache-less forwards give the kernel, in the
    # dtype they run (bfloat16): recurrentgemma-2b's local layers (a GQA
    # group of 10, D 256, window 2048), musicgen-large's self-attention
    # and its cross-attention over the 256-frame memory (non-causal, Sq >>
    # Skv), llava-next-mistral-7b's 2880 + 5312 positions, nemotron-4-15b
    # at its max_seq_len
    PATH_CASES = [
        (1, 10, 1, ARCH_SEQ, ARCH_SEQ, 256, True, 2048, None),
        (1, 32, 32, ARCH_SEQ, ARCH_SEQ, 64, True, None, None),
        (1, 32, 32, ARCH_SEQ, 256, 64, False, None, None),
        (1, 32, 8, ARCH_SEQ, ARCH_SEQ, 128, True, None, None),
        (1, 48, 8, 4096, 4096, 128, True, None, None),
    ]
    STRIDED_CASES = [
        (1, 8, 2, 1024, 1024, 256, True, None, None),
        (2, 8, 4, 128, 256, 128, True, 64, 30.0),
        (1, 4, 2, 128, 128, 64, False, None, None),
        (1, 4, 2, 96, 96, 32, True, None, None),
        (2, 4, 2, 72, 72, 16, True, 16, None),
    ]

    def __init__(self, device):
        import torch
        self.torch = torch
        self.dev = torch.device(device)
        self.max_err = {"flash_attention": 0.0}

    def run(self) -> None:
        torch = self.torch
        from repro_torch.kernels.flash_attention import (
            flash_attention, flash_attention_plain)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        both = (torch.float32, torch.bfloat16)
        cases = [(c, False, both) for c in self.CASES] + \
            [(c, False, (torch.bfloat16,)) for c in self.PATH_CASES] + \
            [(c, True, both) for c in self.STRIDED_CASES]
        for case, strided, dtypes in cases:
            b, hq, hkv, sq, skv, d, causal, window, cap = case
            for dtype in dtypes:
                def randn(*shape):
                    return torch.randn(shape, device=self.dev,
                                       generator=gen).to(dtype)
                if strided:
                    kv = randn(b, skv, 2, hkv, d)
                    q, k, v = (randn(b, sq, hq, d).transpose(1, 2),
                               kv[:, :, 0].transpose(1, 2),
                               kv[:, :, 1].transpose(1, 2))
                    check(not any(t.is_contiguous() for t in (q, k, v)),
                          f"flash_attention {case}: a strided view is dense")
                else:
                    q, k, v = (randn(b, hq, sq, d), randn(b, hkv, skv, d),
                               randn(b, hkv, skv, d))
                kw = dict(causal=causal, window=window, logit_softcap=cap)
                got = flash_attention(q, k, v, **kw).float()
                want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                             v.contiguous(), **kw).float()
                err = (got - want).abs()
                name = str(dtype).split(".")[-1]
                tol, row_tol = FLASH_TOL[name], FLASH_ROW_TOL[name]
                excess = float((err - tol * (1 + want.abs())).max())
                m = float(err.max())
                rel = float(row_rel_err(got, want).max())
                if strided:
                    name += ", strided"
                print(f"   flash_attention {case} {name}: max_abs_err {m!r}"
                      f" (tolerance {tol} x (1 + |want|), max |want| "
                      f"{float(want.abs().max())!r}); row relative error "
                      f"{rel!r} (limit {row_tol})", flush=True)
                check(excess <= 0, f"flash_attention {case} {name}: "
                                   f"outside the tolerance by {excess}")
                check(rel <= row_tol, f"flash_attention {case} {name}: row "
                                      f"relative error {rel} > {row_tol}")
                if causal and window is None and sq == skv >= 4096:
                    # The first 64-key tile dropped from every row: the
                    # plain version over keys 64.. (query i at key 64 + i).
                    cut = flash_attention_plain(q[:, :, 64:], k[:, :, 64:],
                                                v[:, :, 64:], bq=64, bk=64,
                                                **kw)
                    fault = row_rel_err(cut[:, :, sq // 2 - 64:],
                                        want[:, :, sq // 2:])
                    weakest = float(fault.min())
                    print(f"   ... a kernel dropping one 64-key tile of each "
                          f"row of {sq // 2}+ keys would read at least "
                          f"{weakest!r}", flush=True)
                    check(weakest > row_tol, "the row check would not catch "
                                             "a dropped kv tile")
                if causal and skv < sq:
                    check(float(got[:, :, :sq - skv].abs().max()) == 0.0,
                          "flash_attention: a row with no live key is not 0")
                self.max_err["flash_attention"] = max(
                    self.max_err["flash_attention"], m)
        self.run_mla(gen)

    # deepseek-v2-lite's cache-less MLA heads (Hq = Hkv = 16; q, k of 192,
    # v of 128): b, heads, S, Dk, Dv, dtype
    MLA_CASES = [(1, 16, LM_SEQ, 192, 128, "bfloat16"),
                 (1, 16, 1024, 192, 128, "float32"),
                 (1, 16, 200, 192, 128, "bfloat16")]

    def run_mla(self, gen) -> None:
        """MLA's heads through ``ops.attention``: one kernel launch on q,
        k, v zero-padded to 256 at the scale 192^-0.5, held against the
        plain version on the same padded heads, both cut back to 128, with
        the tolerances above."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import cuda, ops
        from repro_torch.kernels.flash_attention import flash_attention_plain
        for case in self.MLA_CASES:
            b, h, s, dk, dv, name = case
            dtype = getattr(torch, name)
            q, k, v = (torch.randn(shape, device=self.dev, generator=gen)
                       .to(dtype) for shape in ((b, h, s, dk), (b, h, s, dk),
                                                (b, h, s, dv)))
            before = cuda.LAUNCHES["flash_attention"]
            got = ops.attention(q, k, v, scale=dk ** -0.5).float()
            torch.cuda.synchronize()
            check(cuda.LAUNCHES["flash_attention"] == before + 1,
                  f"flash_attention MLA {case}: not one kernel launch")
            want = flash_attention_plain(
                *(F.pad(t, (0, 256 - t.shape[-1])) for t in (q, k, v)),
                scale=dk ** -0.5)[..., :dv].float()
            err = (got - want).abs()
            tol, row_tol = FLASH_TOL[name], FLASH_ROW_TOL[name]
            excess = float((err - tol * (1 + want.abs())).max())
            m = float(err.max())
            rel = float(row_rel_err(got, want).max())
            print(f"   flash_attention MLA {case}, padded to 256: "
                  f"max_abs_err {m!r} (tolerance {tol} x (1 + |want|)); row "
                  f"relative error {rel!r} (limit {row_tol})", flush=True)
            check(got.shape == (b, h, s, dv) and excess <= 0,
                  f"flash_attention MLA {case}: outside the tolerance by "
                  f"{excess}")
            check(rel <= row_tol, f"flash_attention MLA {case}: row relative "
                                  f"error {rel} > {row_tol}")
            self.max_err["flash_attention"] = max(
                self.max_err["flash_attention"], m)


# --------------------------------------------------- phase 3: slice parity --


def snapshot(ocf) -> dict:
    from repro_torch.convert import state_to_numpy
    d = state_to_numpy(ocf.state, ocf.stash)
    d["capacity_history"] = list(ocf.capacity_history)
    d["stats"] = dataclasses.asdict(ocf.stats)
    return d


def same_snapshot(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for key, va in a.items():
        vb = b[key]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None or va.shape != vb.shape \
                    or not (va == vb).all():
                return False
        elif va != vb:
            return False
    return True


def parity_stream(n_keys: int, rng: np.random.RandomState):
    """Bursty inserts (grows, failed inserts), verified + blind deletes down
    to a shrink, and lookups of present and absent keys."""
    keys = random_keys(rng, n_keys)
    absent = random_keys(rng, n_keys // 10)
    ops, i = [], 0
    for size in (n_keys // 8, n_keys // 8, n_keys // 4, n_keys // 2):
        ops.append(("insert", keys[i:i + size]))
        i += size
    ops.append(("lookup", np.concatenate([keys[: n_keys // 10], absent])))
    ops.append(("delete", np.concatenate([keys[: n_keys // 20],
                                          absent[: n_keys // 50]])))
    step = n_keys // 8
    for j in range(n_keys // 20, int(n_keys * 0.8), step):
        ops.append(("delete", keys[j:j + step]))
    ops.append(("lookup", np.concatenate([keys[-n_keys // 10:], absent])))
    return ops


def slice_parity(n_keys: int, stash_slots: int):
    from repro_torch.core.ocf import OCF, OcfConfig
    rng = np.random.RandomState(SEED)
    ocfs = [OCF(OcfConfig(capacity=4096, mode="EOF",
                          stash_slots=stash_slots, device=d))
            for d in ("cuda", "cpu")]
    for step, (op, keys) in enumerate(parity_stream(n_keys, rng)):
        answers = [np.asarray(getattr(o, op)(keys)) for o in ocfs]
        check((answers[0] == answers[1]).all(),
              f"{op} #{step}: answers differ between devices")
        snaps = [snapshot(o) for o in ocfs]
        check(same_snapshot(*snaps),
              f"{op} #{step}: filter state differs between devices")
    o = ocfs[0]
    print(f"   stash_slots={stash_slots}: capacity_history="
          f"{o.capacity_history} grows={o.stats.grows} "
          f"shrinks={o.stats.shrinks} failed_inserts="
          f"{o.stats.failed_inserts} stash_spills={o.stats.stash_spills} "
          f"blind_deletes_blocked={o.stats.blind_deletes_blocked}",
          flush=True)
    check(o.stats.grows >= 1 and o.stats.shrinks >= 1,
          "the parity stream did not both grow and shrink")


def adaptive_snapshot(m) -> dict:
    from repro_torch.convert import adaptive_state_to_numpy
    d = adaptive_state_to_numpy(m.filt.state)
    d["stash"] = m.filt.stash.cpu().numpy()
    d["adapted"] = m.filt.adapted
    d["promoted"] = m.reputation.promoted
    d["deferred"] = m.deferred_reports
    return d


def adaptive_parity(label: str, *, n_buckets: int, n_members: int,
                    n_benign: int, late: int = 0):
    """One seeded AdaptiveMembership stream on the card and on the CPU:
    4096-key insert bursts, lookups, two report rounds over the benign
    hits, deletes (with duplicates and absent keys); ``late`` more members
    are inserted after the reports, so their chains kick adapted slots.
    Identical state and answers after every operation."""
    from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
    rng = np.random.RandomState(SEED + 4)
    members = random_keys(rng, n_members + late)
    benign = random_keys(rng, n_benign)
    probe = np.concatenate([members, benign])
    ops = [("insert", members[i:i + CHUNK])
           for i in range(0, n_members, CHUNK)]
    ops += [("lookup", probe), ("report", None), ("lookup", probe),
            ("report", None)]
    ops += [("insert", members[i:i + CHUNK])
            for i in range(n_members, n_members + late, CHUNK)]
    ops += [("lookup", probe),
            ("delete", np.concatenate([members[: n_members // 4],
                                       members[: n_members // 16],
                                       benign[:1000]])),
            ("lookup", probe)]
    ms = [AdaptiveMembership(AdaptiveConfig(n_buckets=n_buckets,
                                            stash_slots=128, device=d))
          for d in ("cuda", "cpu")]
    hits, peak = None, 0.0
    for step, (op, keys) in enumerate(ops):
        if op == "report":
            keys = benign[hits[members.size:]]
        answers = [np.asarray(getattr(m, op)(keys)) for m in ms]
        peak = max(peak, ms[1].filt.fills()[0])
        check((answers[0] == answers[1]).all(),
              f"{label} {op} #{step}: answers differ between devices")
        check(same_snapshot(*(adaptive_snapshot(m) for m in ms)),
              f"{label} {op} #{step}: adaptive state differs between "
              f"devices")
        if op == "lookup":
            hits = answers[1]
    m = ms[1]
    snap = adaptive_snapshot(m)
    print(f"   {label}: peak load={peak!r} "
          f"final load={snap['count'] / (n_buckets * 4)!r} "
          f"stash={int((snap['stash'][0] != 0).sum())} "
          f"adapted={m.filt.adapted} promoted={m.reputation.promoted} "
          f"sels_nonzero={int((snap['sels'] != 0).sum())}", flush=True)
    check(m.filt.adapted > 0, f"{label}: no report adapted a slot")


def ring_snapshot(ring) -> dict:
    from repro_torch.convert import generational_to_numpy
    d = generational_to_numpy(ring)
    for i, g in enumerate(d.pop("gens")):
        for key, value in g.items():
            d[f"gen{i}.{key}"] = value
    return d


def ring_parity(n_events: int = 100_000):
    """One seeded dedup stream through a ring on the card and one on the
    CPU: per tick a lookup of the tick's events (60% fresh, 40% repeats of
    recent ones), an insert of those it missed and a lookup_active of the
    repeats; 8192-slot generations so 4096-key chunks overflow a filling
    generation (spills, a rotate-and-retry) and the ring rotates; one
    explicit rotate, and a quiet gap in the clock that expires every
    generation.  Identical answers, tables, stashes, counts, clock and
    GenStats after every operation."""
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    cfg = dict(generations=3, capacity=8192, stash_slots=32, evict_rounds=8,
               ttl=6.0)
    rings = [GenerationalFilter(GenerationConfig(device=d, **cfg), now=0.0)
             for d in ("cuda", "cpu")]
    rng = np.random.RandomState(SEED + 7)
    recent, done, step, t = [], 0, 0, 0.0

    def both(op, *args, **kw):
        nonlocal step
        answers = [getattr(r, op)(*args, **kw) for r in rings]
        if answers[0] is not None:
            check(np.array_equal(answers[0], answers[1]),
                  f"ring {op} #{step}: answers differ between devices")
        check(same_snapshot(*(ring_snapshot(r) for r in rings)),
              f"ring {op} #{step}: ring state differs between devices")
        step += 1
        return answers[1]

    while done < n_events:
        n = int(rng.choice([3000, 6000, 12000]))
        fresh = random_keys(rng, int(n * 0.6))
        pool = np.concatenate(recent[-3:]) if recent else fresh
        repeats = pool[rng.randint(0, pool.size, n - fresh.size)]
        events = np.concatenate([fresh, repeats])
        new = ~both("lookup", events, now=t)
        both("insert", events[new], now=t)
        both("lookup_active", repeats, now=t)
        recent.append(fresh)
        done += n
        t += 1.0
        if done >= n_events // 2 and t < 20.0:
            both("rotate", now=t)
            t = 20.0                         # a quiet gap: all expire
            both("advance", now=t)
    st = rings[1].stats
    print(f"   ring stream: {done} events, {step} ops, stats={st}",
          flush=True)
    check(st.rotations > 0 and st.expirations > 0 and st.spills > 0
          and st.rotate_retries > 0,
          "the ring stream missed a rotation, expiry, spill or retry")


def batcher_stream(device: str, *, adaptive: bool, telemetry: bool,
                   n_buckets: int = 1024, wave: int = 1024):
    """A seeded wave stream through a ``FilterOpBatcher`` over a 8-slot
    stash on ``device``: insert waves to load ~0.95 (kicks, spills,
    rollbacks), lookups with repeats (dedup) and absent keys, for the
    adaptive filter reports of the false positives, then deletes of the
    acknowledged keys, the last ones twice -> (batcher, wave results,
    registry snapshot without the host's latencies)."""
    from repro_torch.adaptive.state import make_adaptive_state
    from repro_torch.core.filter import make_state
    from repro_torch.core.filter_ops import FilterOps
    from repro_torch.kernels.stash import make_stash
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import FilterOpBatcher

    rng = np.random.RandomState(SEED + 17)
    state = (make_adaptive_state(n_buckets, device=device) if adaptive
             else make_state(n_buckets, device=device))
    m = MetricsRegistry()
    b = FilterOpBatcher(FilterOps(fp_bits=8 if adaptive else 12,
                                  evict_rounds=4),
                        state, stash=make_stash(8, device=device),
                        wave_slots=wave, double_buffer=True,
                        telemetry=telemetry, metrics=m)
    members = random_keys(rng, 4 * wave)
    benign = random_keys(rng, wave)
    waves = [b.submit("insert", members[i:i + wave])
             for i in range(0, members.size, wave)]
    b.flush()
    taken = members[np.concatenate([w.results for w in waves])]
    waves.append(b.submit("lookup", np.concatenate(
        [taken[:wave // 2], taken[:wave // 8], benign[:wave // 4]])))
    if adaptive:
        b.flush()
        waves.append(b.submit("report", benign[:wave // 4][waves[-1].results[
            -(wave // 4):]]))
    waves.append(b.submit("lookup", benign))
    for i in range(0, taken.size, wave):
        waves.append(b.submit("delete", taken[i:i + wave]))
    waves.append(b.submit("delete", taken[-wave // 8:]))
    b.flush()
    snap = {k: v for k, v in m.snapshot().items() if "latency" not in k}
    return b, [w.results for w in waves], snap


def batcher_parity(adaptive: bool) -> None:
    """The filter's serving front (``FilterOpBatcher``) with telemetry on,
    card against CPU on one seeded stream: every wave's results, the
    table (and the adaptive planes), the stash, the count and every
    counter of the registry equal."""
    import torch
    from repro_torch.kernels import cuda
    cuda.reset_counts()
    card, card_res, card_snap = batcher_stream("cuda", adaptive=adaptive,
                                               telemetry=True)
    tm_launches = {k: cuda.LAUNCHES[k] for k in cuda.TM_KERNELS
                   if cuda.LAUNCHES[k]}
    cpu, cpu_res, cpu_snap = batcher_stream("cpu", adaptive=adaptive,
                                            telemetry=True)
    label = "adaptive" if adaptive else "static"
    check(len(card_res) == len(cpu_res) and all(
        np.array_equal(a, b) for a, b in zip(card_res, cpu_res)),
        f"batcher stream ({label}): a wave's results differ, card vs CPU")
    planes = ("table", "sels", "khi", "klo") if adaptive else ("table",)
    for plane in planes:
        check(torch.equal(getattr(card.state, plane).cpu(),
                          getattr(cpu.state, plane)),
              f"batcher stream ({label}): {plane} differs, card vs CPU")
    check(torch.equal(card.stash.cpu(), cpu.stash)
          and int(card.state.count) == int(cpu.state.count),
          f"batcher stream ({label}): stash or count differs")
    check(card_snap == cpu_snap,
          f"batcher stream ({label}): counters differ, card {card_snap} vs "
          f"CPU {cpu_snap}")
    want = ["filter_stash_spills", "filter_rollback_lanes",
            "filter_stash_deletes", "filter_table_deletes"]
    if adaptive:
        want.append("filter_selector_bumps")
    zero = [k for k in want if not card_snap.get(k)]
    check(not zero, f"batcher stream ({label}): counters never moved: {zero}")
    counters = {k: v for k, v in card_snap.items()
                if k.startswith(("filter_stash", "filter_rollback",
                                 "filter_selector", "filter_table",
                                 "filter_probe"))}
    print(f"   batcher stream ({label}, telemetry on): {len(card_res)} waves, "
          f"tm launches {tm_launches}, kick depth "
          f"{card_snap['filter_kick_depth']['counts']}, {counters}: same "
          f"as the CPU", flush=True)


def prefix_index_parity(steps: int = 40):
    """One seeded GenerationalPrefixIndex stream (shared system prompts,
    varied user turns, a TTL on a logical clock) on the card and the CPU:
    identical answers, PrefixStats and ring state after every call."""
    from repro_torch.serving import GenerationalPrefixIndex
    idx = [GenerationalPrefixIndex(block=32, capacity=4096, generations=3,
                                   ttl=5.0, now=0.0, device=d)
           for d in ("cuda", "cpu")]
    rng = np.random.RandomState(SEED + 8)
    systems = [rng.randint(0, 32000, 256).astype(np.uint32)
               for _ in range(4)]
    for step in range(steps):
        now = 0.5 * step
        prompt = np.concatenate([
            systems[rng.randint(len(systems))],
            rng.randint(0, 32000, int(rng.randint(64, 257))).astype(
                np.uint32)])
        for op in ("match_prefix", "admit"):
            answers = [getattr(i, op)(prompt, now=now) for i in idx]
            check(answers[0] == answers[1],
                  f"prefix {op} #{step}: answers differ between devices")
            check(dataclasses.asdict(idx[0].stats)
                  == dataclasses.asdict(idx[1].stats)
                  and same_snapshot(*(ring_snapshot(i.filt) for i in idx)),
                  f"prefix {op} #{step}: state differs between devices")
    st, gs = idx[1].stats, idx[1].filt.stats
    print(f"   prefix index: {st} hit_rate={idx[1].hit_rate!r} ring={gs}",
          flush=True)
    check(st.block_hits > 0 and gs.expirations > 0,
          "the prefix stream never hit or never expired a generation")


def lm_parity(seqs=(512, 200), steps: int = 8):
    """gemma3-1b at full width, one period deep (6 layers), float32, TF32
    off: one seeded init on the CPU, copied to the card.  The cache-less
    forward's logits agree within 1e-3 (float32 sums in other orders on
    the two devices, through 6 layers and a 1152-wide unembedding; logits
    are O(1)) at each length of ``seqs`` (200 is no multiple of the flash
    kernel's tiles); the greedy tokens of prefill + ``steps`` decode steps
    of the first are equal."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    from repro_torch.serving.engine import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=6,
                              dtype="float32")
    cpu = Transformer(cfg, seed=SEED, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    for i, seq in enumerate(seqs):
        toks = torch.from_numpy(np.random.RandomState(SEED + 10).randint(
            0, cfg.vocab_size, (1, seq)))
        cuda.reset_counts()
        a = card.apply(toks.cuda()).logits
        torch.cuda.synchronize()
        check(cuda.LAUNCHES["flash_attention"] == cfg.n_layers,
              "the card's forward did not launch flash_attention per layer")
        b = cpu.apply(toks).logits
        err = float((a.cpu() - b).abs().max())
        print(f"   LM {cfg.name} x{cfg.n_layers} layers, float32, S={seq}: "
              f"logits max_abs_err card vs cpu {err!r} (max |logit| "
              f"{float(b.abs().max())!r})", flush=True)
        check(err < 1e-3, f"LM logits differ between devices by {err}")
        if i == 0:
            gen = [generate(m, t, steps + 1).tokens.cpu().numpy()
                   for m, t in ((card, toks.cuda()), (cpu, toks))]
            print(f"   greedy tokens {gen[0].tolist()} / "
                  f"{gen[1].tolist()}", flush=True)
            check(np.array_equal(*gen), "greedy tokens differ between "
                                        "devices")
    return card, cpu


def token_flips(routes_a, routes_b) -> list:
    """Tokens whose MoE routing differs between two runs of one layer ->
    [(token, gap), ...], tokens counted across the ``Routing``s of each
    run in order (calls of one run, groups of a call).  A token differs
    where its chosen experts or its first choice do; its gap is run b's
    gate gap at the boundary the difference crosses (k-th against (k+1)-th
    probability for the set, first against second for the first
    choice)."""
    import torch

    def flat(routes):
        k, e = routes[0].expert.shape[-1], routes[0].probs.shape[-1]
        return (torch.cat([r.expert.cpu().reshape(-1, k) for r in routes]),
                torch.cat([r.probs.cpu().reshape(-1, e) for r in routes]))
    (ea, _), (eb, pb) = flat(routes_a), flat(routes_b)
    k = eb.shape[-1]
    set_diff = (ea.sort(dim=-1).values != eb.sort(dim=-1).values).any(dim=-1)
    diff = set_diff | (ea[:, 0] != eb[:, 0])
    p = pb.sort(dim=-1, descending=True).values
    gap = (p[:, k - 1] - p[:, k]).where(set_diff, p[:, 0] - p[:, 1])
    return [(int(t), float(gap[t])) for t in diff.nonzero()[:, 0].tolist()]


def admit_flips(flips, label: str) -> int:
    """Print each routing difference, fatal unless a near tie (a gate gap
    <= MOE_NEAR_TIE) -> the first token that differs (or a large int)."""
    for t, gap in flips:
        print(f"   {label}: token {t} routed differently, gate gap {gap!r} "
              f"(admitted at <= {MOE_NEAR_TIE})", flush=True)
        check(gap <= MOE_NEAR_TIE, f"{label}: token {t} routed differently "
                                   f"at a gate gap of {gap}")
    return min([t for t, _ in flips], default=1 << 62)


def first_flip(runs_a: list, runs_b: list, n_layers: int, label: str) -> int:
    """The first token routed differently in any MoE layer between two
    runs of a model, each a list of calls' ``routes`` lists (near ties
    admitted, others fatal): no token before it saw a difference, in any
    layer (causal attention; capacity ranks count earlier tokens only)."""
    return min([admit_flips(token_flips([c[n] for c in runs_a],
                                        [c[n] for c in runs_b]),
                            f"{label}, MoE layer {n}")
                for n in range(n_layers)], default=1 << 62)


def moe_parity(seqs=(512, 1024), steps: int = 8) -> None:
    """deepseek-v2-lite-16b at full width, 3 layers deep (the dense MLA
    prefix and 2 MLA + MoE blocks), float32, TF32 off: one seeded init on
    the CPU, copied to the card.  At S = 512 (one routing group) and 1024
    (two), each layer runs on the CPU's input to it on both devices: the
    expert choices equal (a difference only at a near tie, a CPU gate gap
    <= MOE_NEAR_TIE, printed; its group's tokens then leave the output
    check), ``keep`` equal, the outputs row by row within MOE_ROW_TOL.
    Then the end-to-end logits within 1e-3 (on the tokens before the first
    near-tie difference, if one occurs) and the aux loss within 1e-6; the
    greedy tokens of prefill + ``steps`` decode steps at 512 equal."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    from repro_torch.models.layers import embed
    from repro_torch.serving.engine import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=3,
                              dtype="float32")
    cpu = Transformer(cfg, seed=SEED, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    d = cfg.d_model
    with torch.no_grad():
        for seq in seqs:
            toks = torch.from_numpy(np.random.RandomState(SEED + 12).randint(
                0, cfg.vocab_size, (1, seq)))
            x = embed(cpu.emb["embed"], toks, cfg)
            rot_c, rot_g = cpu.rotation(1, seq), card.rotation(1, seq)
            for n, (lc, lg) in enumerate(zip(cpu.layers, card.layers)):
                rc, rg = [], []
                y, _, _ = lc(x, rot=rot_c, routes=rc)
                yg, _, _ = lg(x.cuda(), rot=rot_g, routes=rg)
                rows = torch.ones(seq, dtype=torch.bool)
                what = "dense MLP"
                if rc:
                    label = f"MoE S={seq} layer {n}"
                    flips = token_flips(rg, rc)
                    admit_flips(flips, label)
                    t = rc[0].expert.shape[1]       # tokens a group
                    flipped = {tok // t for tok, _ in flips}
                    keep = (rg[0].keep.cpu() != rc[0].keep).any(dim=-1)
                    bad = {int(g) for g in keep.any(dim=-1).nonzero()[:, 0]}
                    check(not bad - flipped,
                          f"{label}: keep differs in groups "
                          f"{sorted(bad - flipped)} without a routing "
                          f"difference")
                    for g in flipped:
                        rows[g * t:(g + 1) * t] = False
                    what = (f"experts equal on {seq - len(flips)} of {seq} "
                            f"tokens, {int((~rc[0].keep).sum())} of "
                            f"{rc[0].keep.numel()} (token, choice) pairs "
                            f"dropped at capacity {rc[0].capacity}")
                rel = float(row_rel_err(yg.cpu().reshape(-1, d)[rows],
                                        y.reshape(-1, d)[rows]).max())
                print(f"   {MOE_ARCH} x3 float32 S={seq} layer {n} "
                      f"({cpu.slots[n][0]}): {what}; output row relative "
                      f"error card vs cpu {rel!r} (limit {MOE_ROW_TOL})",
                      flush=True)
                check(rel <= MOE_ROW_TOL, f"MoE S={seq} layer {n}: outputs "
                                          f"differ by {rel}")
                x = y
            rg, rc = [], []
            cuda.reset_counts()
            a = card.apply(toks.cuda(), routes=rg)
            torch.cuda.synchronize()
            check(cuda.LAUNCHES["flash_attention"] == cfg.n_layers,
                  "the card's forward did not launch flash_attention per "
                  "layer")
            b = cpu.apply(toks, routes=rc)
            first = min(seq, first_flip([rg], [rc], len(rc),
                                        f"MoE S={seq} end to end"))
            err = float((a.logits.cpu()[:, :first]
                         - b.logits[:, :first]).abs().max())
            aux = abs(float(a.aux_loss) - float(b.aux_loss))
            print(f"   {MOE_ARCH} x3 float32 S={seq}: logits max_abs_err card "
                  f"vs cpu {err!r} on {first} of {seq} tokens (max |logit| "
                  f"{float(b.logits.abs().max())!r}); aux loss "
                  f"{float(a.aux_loss)!r} / {float(b.aux_loss)!r}, "
                  f"difference {aux!r}", flush=True)
            check(err < 1e-3, f"MoE logits differ between devices by {err}")
            if first == seq:
                check(aux <= 1e-6, f"MoE aux losses differ by {aux}")
            if seq == seqs[0]:
                gen = [generate(m, tk, steps + 1).tokens.cpu().numpy()
                       for m, tk in ((card, toks.cuda()), (cpu, toks))]
                print(f"   {MOE_ARCH} greedy tokens {gen[0].tolist()} / "
                      f"{gen[1].tolist()}", flush=True)
                check(np.array_equal(*gen), "MoE greedy tokens differ "
                                            "between devices")
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()


def arch_conditions(cfg, batch: int, seed: int, *, dtype, device,
                    prefix_len=None) -> dict:
    """The conditioning inputs of a config, seeded: musicgen's
    text-encoder memory [B, M, memory_dim] of N(0, 1), llava's prefix
    embeddings [B, P, E] of N(0, 1 / E) (the scale of the token
    embeddings' rows); {} for the others.  ``prefix_len`` overrides P."""
    import torch
    rng = np.random.RandomState(seed)
    if cfg.cross_attn_memory_len:
        mem = rng.randn(batch, cfg.cross_attn_memory_len,
                        cfg.cross_attn_memory_dim)
        return {"memory": torch.from_numpy(mem).to(device, dtype)}
    if cfg.prefix_embed_len:
        p = prefix_len or cfg.prefix_embed_len
        pre = rng.randn(batch, p, cfg.d_model) / np.sqrt(cfg.d_model)
        return {"prefix_embeds": torch.from_numpy(pre).to(device, dtype)}
    return {}


def attention_layers(model) -> int:
    """Flash launches of one cache-less forward: one a global or local
    layer, two where its cross-attention has a memory (the caller's
    count)."""
    return sum(kind in ("global", "local") for kind in model.kinds)


def arch_parity(steps: int = 4) -> None:
    """Phase 3 for the SSM, RG-LRU, cross-attention and prefix configs and
    nemotron: each at full width, ARCH_PARITY's depth and tokens, float32,
    TF32 off, one seeded init on the card copied to the CPU.  The
    cache-less forward's logits agree within 1e-3, with the conditioning
    inputs (musicgen's memory, ARCH_PARITY_PREFIX of llava's prefix
    embeddings), and the flash kernel ran once a layer (twice with a
    memory); the greedy tokens of prefill + ``steps`` decode steps are
    equal."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    from repro_torch.serving.engine import generate
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, (layers, seq) in ARCH_PARITY.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        card = Transformer(cfg, seed=SEED, device="cuda")
        cpu = copy.deepcopy(card).to("cpu")
        toks = torch.from_numpy(np.random.RandomState(SEED + 15).randint(
            0, cfg.vocab_size, (1, seq)))
        kw = arch_conditions(cfg, 1, SEED + 16, dtype=torch.float32,
                             device="cpu", prefix_len=ARCH_PARITY_PREFIX)
        kw_card = {k: v.cuda() for k, v in kw.items()}
        cuda.reset_counts()
        a = card.apply(toks.cuda(), **kw_card).logits
        torch.cuda.synchronize()
        per = attention_layers(card) * (2 if "memory" in kw else 1)
        check(cuda.LAUNCHES["flash_attention"] == per and
              not sum(cuda.PLAIN_CALLS.values()),
              f"{arch}: the card's forward launched "
              f"{cuda.LAUNCHES['flash_attention']} flash kernels, not {per}")
        b = cpu.apply(toks, **kw).logits
        err = float((a.cpu() - b).abs().max())
        gen = [generate(m, t, steps + 1, **c).tokens.cpu().numpy()
               for m, t, c in ((card, toks.cuda(), kw_card),
                               (cpu, toks, kw))]
        print(f"   {cfg.name} x{layers} layers, float32, S={seq}"
              f"{''.join(f' + {k}' for k in kw)}: logits max_abs_err card vs cpu {err!r} "
              f"(max |logit| {float(b.abs().max())!r}), flash launches "
              f"{per}; greedy tokens {gen[0].tolist()} / {gen[1].tolist()} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(err < 1e-3, f"{arch}: logits differ between devices by {err}")
        check(np.array_equal(*gen), f"{arch}: greedy tokens differ between "
                                    f"devices")
        del card, cpu, a, b
        gc.collect()
        torch.cuda.empty_cache()


def slo_recorder():
    """A ``SloHarness`` that keeps what a replay drove: ``target`` (the
    batcher or the ring) and ``waves`` in submit order (kind, keys, and the
    ``OpWave`` or the ring call's answer); for a batcher ``launched``, its
    waves in launch order with their keys (a wave parked by admission
    launches later than it was submitted); for a ring each call's clock,
    the generation an insert went into (None when the call rotated) and
    the generations live at a lookup."""
    from repro_torch.serving.slo import SloHarness

    class Recording(SloHarness):
        def run(self, batcher, stream, **kw):
            self.target, self.waves, self.launched = batcher, [], []
            submit, launch = batcher.submit, batcher._launch

            def submitted(kind, keys):
                wave = submit(kind, keys)
                self.waves.append((kind, keys, wave))
                return wave

            def launched(wave, keys):
                self.launched.append((wave, keys))
                launch(wave, keys)
            batcher.submit, batcher._launch = submitted, launched
            return super().run(batcher, stream, **kw)

        def run_generational(self, filt, stream, **kw):
            self.target, self.waves = filt, []
            insert, lookup = filt.insert, filt.lookup

            def inserted(keys, now=None):
                before = (filt.stats.rotations, filt.stats.rotate_retries)
                ok = insert(keys, now=now)
                calm = before == (filt.stats.rotations,
                                  filt.stats.rotate_retries)
                self.waves.append(("insert", keys, ok,
                                   filt.gens[-1] if calm else None, now))
                return ok

            def looked_up(keys, now=None):
                live = [g for g in filt.gens if g.live(now)]
                hits = lookup(keys, now=now)
                self.waves.append(("lookup", keys, hits, live, now))
                return hits
            filt.insert, filt.lookup = inserted, looked_up
            return super().run_generational(filt, stream, **kw)
    return Recording()


def slo_fields(rep) -> dict:
    """An ``SloReport``'s fields that are no host time."""
    return {"ops": rep.ops, "waves": rep.waves, "shed_ops": rep.shed_ops,
            "deferred_waves": rep.deferred_waves,
            "held_ticks": rep.held_ticks, "extras": rep.extras,
            "samples": [(x.kind, x.ops, x.burst, x.deferred)
                        for x in rep.recorder.samples]}


def slo_same_waves(a, b) -> bool:
    """Two recordings' waves: the same kinds, keys, results (None for a
    shed wave) and parked ticks."""
    if len(a.waves) != len(b.waves):
        return False
    for x, y in zip(a.waves, b.waves):
        if x[0] != y[0] or not np.array_equal(x[1], y[1]):
            return False
        rx, ry = x[2], y[2]
        if hasattr(rx, "results"):
            if rx.deferred_ticks != ry.deferred_ticks:
                return False
            rx, ry = rx.results, ry.results
        if (rx is None) != (ry is None) or (
                rx is not None and not np.array_equal(rx, ry)):
            return False
    return True


def slo_same_stack(a, b) -> bool:
    """Two batchers' final planes, stash and count, or two rings' state."""
    import torch
    if hasattr(a, "gens"):
        return same_snapshot(ring_snapshot(a), ring_snapshot(b))
    planes = [p for p in ("table", "sels", "khi", "klo")
              if hasattr(a.state, p)]
    return (all(torch.equal(getattr(a.state, p).cpu(),
                            getattr(b.state, p).cpu()) for p in planes)
            and int(a.state.count) == int(b.state.count)
            and (a.stash is None) == (b.stash is None)
            and (a.stash is None or torch.equal(a.stash.cpu(),
                                                b.stash.cpu())))


def slo_parity() -> None:
    """Every scenario of the SLO harness through ``run_scenario`` with the
    reference's defaults (its stacks, 512-key waves, the generators'
    lengths), on the card and on the CPU: every wave's results, the final
    state (the ring's generations for ``ttl_churn``) and every report field
    that is no host time equal."""
    from repro_torch.serving.slo import BENCH_SCENARIOS, run_scenario
    for name in BENCH_SCENARIOS:
        runs = []
        for device in ("cuda", "cpu"):
            h = slo_recorder()
            runs.append((h, run_scenario(name, seed=SEED, device=device,
                                         harness=h)))
        (ch, crep), (ph, prep) = runs
        check(slo_same_waves(ch, ph),
              f"scenario {name}: a wave differs, card vs CPU")
        check(slo_same_stack(ch.target, ph.target),
              f"scenario {name}: the final state differs, card vs CPU")
        check(slo_fields(crep) == slo_fields(prep),
              f"scenario {name}: the report differs, card vs CPU")
        print(f"   scenario {name}: {crep.waves} waves, {crep.ops} ops, "
              f"extras {crep.extras}: same as the CPU (card p99 "
              f"{crep.percentiles_us['p99']!r} us)", flush=True)


def burst_prompts(vocab: int, n: int = 7) -> list:
    """tests/test_scheduler.py's burst: 64-token prompts, the even ones
    sharing a 48-token prefix."""
    rng = np.random.RandomState(SEED)
    shared = rng.randint(0, vocab, 48).astype(np.int32)
    return [np.concatenate([shared, rng.randint(0, vocab, 16).astype(
        np.int32)]) if i % 2 == 0 else rng.randint(0, vocab, 64).astype(
        np.int32) for i in range(n)]


def continuous_batcher_parity(card_model, cpu_model) -> None:
    """tests/test_scheduler.py's burst of 7 requests into 3 slots through
    ``ContinuousBatcher`` over the card's and the CPU's copy of one model:
    equal greedy tokens, ``SchedStats`` equal field by field."""
    from repro_torch.serving import ContinuousBatcher, Request
    prompts = burst_prompts(cpu_model.cfg.vocab_size)
    out = []
    for model in (card_model, cpu_model):
        b = ContinuousBatcher(model, slots=3, cache_len=128, block=16)
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            b.submit(r)
        check(b.congestion > 1.0, "the burst did not exceed the slots")
        stats = b.run_until_drained()
        out.append(([r.out for r in reqs], dataclasses.asdict(stats)))
    (card_toks, card_stats), (cpu_toks, cpu_stats) = out
    print(f"   ContinuousBatcher burst: tokens {card_toks} / {cpu_toks}, "
          f"stats {card_stats}", flush=True)
    check(card_toks == cpu_toks, "ContinuousBatcher: greedy tokens differ "
                                 "between devices")
    check(card_stats == cpu_stats, f"ContinuousBatcher: SchedStats differ: "
                                   f"{card_stats} vs {cpu_stats}")
    check(card_stats["finished"] == 7
          and card_stats["prefix_blocks_reused"] > 0,
          "ContinuousBatcher: the burst did not drain or reuse a prefix")


# ------------------------------------------------------ phase 4: main path --


def main_path(device, card: str, *, capacity=1 << 22, bursts=8,
              burst=1_000_000, n_delete=3_000_000, n_blind=100_000,
              n_absent=5_000_000):
    import torch
    from repro_torch.core.metrics import (measure_false_negatives,
                                          measure_false_positives,
                                          theoretical_fp_rate)
    from repro_torch.core.ocf import OCF, OcfConfig
    from repro_torch.kernels import cuda

    rng = np.random.RandomState(SEED + 1)
    keys = random_keys(rng, bursts * burst)
    blind = random_keys(rng, n_blind)
    absent = random_keys(rng, n_absent)
    ocf = OCF(OcfConfig(capacity=capacity, bucket_size=4, fp_bits=16,
                        mode="EOF", device=device))

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    sync()
    cuda.reset_counts()
    t0 = time.perf_counter()
    for b in range(bursts):
        ocf.insert(keys[b * burst:(b + 1) * burst])
    sync()
    t_ins = time.perf_counter() - t0
    t0 = time.perf_counter()
    present = ocf.delete(np.concatenate([keys[:n_delete], blind]))
    sync()
    t_del = time.perf_counter() - t0
    resident = keys[n_delete:]
    t0 = time.perf_counter()
    hits = ocf.lookup(np.concatenate([resident, absent]))
    sync()
    t_look = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    plain = dict(cuda.PLAIN_CALLS)

    fn = int((~hits[: resident.size]).sum())
    fp = int(hits[resident.size:].sum())
    occ = ocf.occupancy
    eps = theoretical_fp_rate(4, 16, occ)
    fp_rate = fp / absent.size
    print(f"   capacity_history={ocf.capacity_history}", flush=True)
    print(f"   stats={dataclasses.asdict(ocf.stats)}", flush=True)
    print(f"   false_negatives={fn} false_positives={fp} fp_rate={fp_rate!r}"
          f" theoretical={eps!r} occupancy={occ!r}", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    n_ins, n_del = bursts * burst, n_delete + n_blind
    n_look = resident.size + absent.size
    print(f"   [{card}] insert {n_ins / t_ins!r} keys/s ({t_ins!r} s), "
          f"delete {n_del / t_del!r} keys/s ({t_del!r} s), lookup "
          f"{n_look / t_look!r} keys/s ({t_look!r} s)", flush=True)

    check(fn == 0, f"{fn} false negatives")
    check(int(present.sum()) == n_delete, "a verified delete was refused")
    check(ocf.stats.blind_deletes_blocked == n_blind,
          "blind deletes were not all blocked")
    check(ocf.stats.grows >= 1, "the main path never grew the filter")
    check(fp_rate <= 4 * eps, f"fp rate {fp_rate} > 4 x {eps}")
    check(measure_false_negatives(ocf, resident[:100_000]) == 0,
          "measure_false_negatives found a miss")
    check(measure_false_positives(ocf, absent[:100_000]) <= 100_000 * 4 * eps
          + 10, "measure_false_positives out of bound")
    return ocf, resident, launches, plain, {
        "insert_s": t_ins, "delete_s": t_del, "lookup_s": t_look}


# ---------------------------------------------- phase 5: the adaptive path --


def adaptive_path(card: str, *, n_buckets=1 << 22, bursts=12,
                  burst=1_000_000, n_benign=10_000_000, rounds=4,
                  n_delete=3_000_000):
    """An abuse-detection denylist of one node (the deployment of
    examples/adaptive_abuse_detection.py at 16M slots): member bursts, a
    lookup of every member, feedback rounds over one replayed benign
    population, deletes, and a lookup of the remaining members."""
    import torch
    from repro_torch.adaptive import AdaptiveConfig, AdaptiveMembership
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stash import stash_occupancy
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(SEED + 3)
    members = random_keys(rng, bursts * burst)
    benign = random_keys(rng, n_benign)
    m = AdaptiveMembership(AdaptiveConfig(n_buckets=n_buckets, bucket_size=4,
                                          fp_bits=16, stash_slots=128))
    times, phases = {}, []

    def timed(name, fn):
        before = dict(cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        phases.append((name, {k: v - before.get(k, 0)
                              for k, v in cuda.LAUNCHES.items()
                              if v != before.get(k, 0)}))
        return out

    # One CUDA-activity trace over the whole path gives the device's busy
    # time per kernel (the host's time is the rest of each phase).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        cuda.reset_counts()
        ok = np.concatenate([timed("insert", lambda b=b: m.insert(
            members[b * burst:(b + 1) * burst])) for b in range(bursts)])
        acked = members[ok]
        load = m.filt.fills()[0]
        hit = timed("member lookup", lambda: m.lookup(members))
        fn_before = int((~hit[ok]).sum())
        fp_rounds = []
        for r in range(rounds):
            hits = timed("benign lookup", lambda: m.lookup(benign))
            fps = benign[hits]
            adapted = timed("report", lambda: m.report(fps))
            fp_rounds.append((int(fps.size), int(adapted.sum()),
                              m.reputation.promoted, m.deferred_reports))
        d_ok = timed("delete", lambda: m.delete(acked[:n_delete]))
        remaining = acked[n_delete:]
        hit_r = timed("member lookup", lambda: m.lookup(remaining))
        fn_after = int((~hit_r).sum())
        launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    device_s = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or 0.0
        if us > 0:
            device_s[ev.key] = device_s.get(ev.key, 0.0) + us / 1e6

    stash_n = int(stash_occupancy(m.filt.stash))
    eps = 2 * 4 * load / 2 ** 16
    for name, counts in phases:
        print(f"   phase {name}: launches {counts}", flush=True)
    print(f"   load after inserts={load!r} failed inserts="
          f"{int((~ok).sum())} stash occupancy={stash_n} "
          f"false negatives before deletes={fn_before} after={fn_after}",
          flush=True)
    for r, (n_fp, n_ad, n_pr, n_def) in enumerate(fp_rounds):
        print(f"   [{card}] round {r}: false positives={n_fp} "
              f"(rate {n_fp / n_benign!r}, bound 4 x {eps!r}) "
              f"adapted={n_ad} promoted={n_pr} deferred={n_def}",
              flush=True)
    n_look = members.size + remaining.size
    print(f"   [{card}] insert {bursts * burst / times['insert']!r} keys/s, "
          f"member lookup {n_look / times['member lookup']!r} keys/s, "
          f"benign lookup {rounds * n_benign / times['benign lookup']!r} "
          f"keys/s, report {sum(r[0] for r in fp_rounds) / times['report']!r}"
          f" keys/s ({times['report']!r} s), delete "
          f"{n_delete / times['delete']!r} keys/s", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    wall = sum(times.values())
    busy = sum(device_s.values())
    print(f"   [{card}] device busy {busy!r} s of {wall!r} s of phases "
          f"(idle share {1 - busy / wall!r})", flush=True)
    for kernel, phase_names in (
            ("insert_adaptive_kernel", ("insert",)),
            ("probe_adaptive_kernel", ("member lookup", "benign lookup")),
            ("family_kernel", ("report",)),
            ("delete_adaptive_kernel", ("delete",))):
        k_s = sum(v for key, v in device_s.items() if kernel in key)
        p_s = sum(times[n] for n in phase_names)
        print(f"   {kernel}: {k_s!r} s on the device, {k_s / p_s!r} of "
              f"its phases ({'+'.join(phase_names)}, {p_s!r} s)", flush=True)

    check(fn_before == 0 and fn_after == 0,
          f"false negatives: {fn_before} before, {fn_after} after deletes")
    check(bool(d_ok.all()), "a verified delete was refused")
    check(fp_rounds[0][0] / n_benign <= 4 * eps,
          f"round 0 fp rate {fp_rounds[0][0] / n_benign} > 4 x {eps}")
    check(fp_rounds[-1][0] <= 0.01 * fp_rounds[0][0],
          f"the last round kept {fp_rounds[-1][0]} of "
          f"{fp_rounds[0][0]} false positives")
    return m, remaining, launches, plain, {
        "load": load, "fp_rounds": fp_rounds, "times": times,
        "device_s": device_s, "benign": benign}


# ------------------------------- phase 5d: filter-op waves at full size --


# Phase 5d's depth: lookups of absent keys and deletes a quarter of the
# acknowledged keys (half and as many before), and two repeated arms of a
# family (four before); table, wave width and the inserts to load 0.85 stay.
WAVE_CUT = 4
WAVE_REPEATS = ("on", "off")


def filter_wave_run(keys: np.ndarray, absent: np.ndarray, *,
                    adaptive: bool, telemetry: bool, n_buckets: int,
                    wave: int, stash_slots: int, load: float) -> dict:
    """One arm of phase 5d: a ``FilterOpBatcher`` over a fresh state and
    stash on the card; insert waves of ``keys``, lookup waves over every
    acknowledged key and a ``WAVE_CUT``-th as many of ``absent``, for the
    adaptive filter report waves of the absent keys that hit, then delete
    waves over the first ``WAVE_CUT``-th of the acknowledged keys."""
    import torch
    from repro_torch.adaptive.state import make_adaptive_state
    from repro_torch.core.filter import make_state
    from repro_torch.core.filter_ops import FilterOps, evict_rounds_for_load
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stash import make_stash
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serving import FilterOpBatcher

    m = MetricsRegistry()
    b = FilterOpBatcher(
        FilterOps(fp_bits=16, evict_rounds=evict_rounds_for_load(load),
                  donate=True),
        (make_adaptive_state if adaptive else make_state)(n_buckets, 4),
        stash=make_stash(stash_slots), wave_slots=wave, double_buffer=True,
        telemetry=telemetry, metrics=m)

    def waves(kind, k):
        return [b.submit(kind, k[i:i + wave]) for i in range(0, k.size, wave)]

    gc.collect()      # the earlier arms' garbage, outside the timed span
    torch.cuda.synchronize()
    cuda.reset_counts()
    t0 = time.perf_counter()
    ins = waves("insert", keys)
    b.flush()
    acked = keys[np.concatenate([w.results for w in ins])]
    n_absent = acked.size // WAVE_CUT
    look = waves("lookup", np.concatenate([acked, absent[:n_absent]]))
    reps = []
    if adaptive:
        b.flush()
        hit = np.concatenate([w.results for w in look])[acked.size:]
        reps = waves("report", absent[:n_absent][hit])
    dels = waves("delete", acked[: acked.size // WAVE_CUT])
    b.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    every = ins + look + reps + dels
    return {"wall": wall, "waves": len(every),
            "keys": sum(w.n for w in every), "acked": acked.size,
            "hits": np.concatenate([w.results for w in look]),
            "reported": sum(w.n for w in reps),
            "deleted": np.concatenate([w.results for w in dels]),
            "results": [w.results for w in every],
            "probed": sum(w._n_probe for w in look),
            "planes": [p.cpu() for p in b.state[:-2]],
            "stash": b.stash.cpu(), "count": int(b.state.count),
            "launches": launches, "plain": plain, "snapshot": m.snapshot()}


def filter_wave_family(card: str, adaptive: bool, keys, absent,
                       **kw) -> dict:
    """Phase 5d for one state family: telemetry off, on, then
    ``WAVE_REPEATS`` from the same seed (walls in turns, the median of an
    arm's runs), then each once more under a CUDA-activity trace; checks
    the arms equal and the counters' sums."""
    import torch
    from repro_torch.kernels import cuda
    from torch.profiler import ProfilerActivity, profile

    label = "adaptive" if adaptive else "static"
    for tm in (False, True):        # warm-up: the first waves' set-up
        filter_wave_run(keys[: 16 * kw["wave"]], absent, adaptive=adaptive,
                        telemetry=tm, **kw)
    arms = {"off": filter_wave_run(keys, absent, adaptive=adaptive,
                                   telemetry=False, **kw),
            "on": filter_wave_run(keys, absent, adaptive=adaptive,
                                  telemetry=True, **kw)}
    off, on = arms["off"], arms["on"]
    walls = {"off": [off["wall"]], "on": [on["wall"]]}
    plain = collections.Counter(off["plain"]) + collections.Counter(
        on["plain"])
    for name in WAVE_REPEATS:
        t = filter_wave_run(keys, absent, adaptive=adaptive,
                            telemetry=name == "on", **kw)
        check(t["count"] == off["count"],
              f"filter-op waves ({label}): a repeated arm left another "
              f"count")
        walls[name].append(t["wall"])
        plain.update(t["plain"])         # Counter.update adds
        del t
    busy = {}
    for name, tm in (("off", False), ("on", True)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced = filter_wave_run(keys, absent, adaptive=adaptive,
                                     telemetry=tm, **kw)
        busy[name] = (sum((getattr(ev, "device_time_total", 0.0) or 0.0)
                          for ev in prof.key_averages()) / 1e6,
                      traced["wall"])
        check(traced["count"] == arms[name]["count"],
              f"filter-op waves ({label}): the traced {name} arm left "
              f"another count")

    check(len(off["results"]) == len(on["results"]) and all(
        np.array_equal(a, b) for a, b in zip(off["results"], on["results"])),
        f"filter-op waves ({label}): a wave's results differ with "
        f"telemetry on")
    check(all(torch.equal(a, b) for a, b in zip(off["planes"], on["planes"]))
          and torch.equal(off["stash"], on["stash"])
          and off["count"] == on["count"],
          f"filter-op waves ({label}): the state differs with telemetry on")
    fn = int((~on["hits"][: on["acked"]]).sum())
    check(fn == 0, f"filter-op waves ({label}): {fn} false negatives")
    tm_off = {k: v for k, v in off["launches"].items()
              if k in cuda.TM_KERNELS}
    check(not tm_off, f"the telemetry-off arm ({label}) launched {tm_off}")
    snap = on["snapshot"]
    kicks = sum(snap["filter_kick_depth"]["counts"])
    depth = sum(v for k, v in snap.items()
                if k.startswith("filter_probe_depth"))
    deletes = snap.get("filter_table_deletes", 0) + snap.get(
        "filter_stash_deletes", 0)
    n_del = int(on["deleted"].sum())
    check(kicks == keys.size, f"{label}: kick_hist sums to {kicks}, not the "
                              f"{keys.size} insert lanes offered")
    check(depth == on["probed"], f"{label}: probe_depth sums to {depth}, "
                                 f"not the {on['probed']} lanes probed")
    check(deletes == n_del, f"{label}: table + stash deletes {deletes} != "
                            f"{n_del} acknowledged deletes")
    if adaptive:
        check(snap.get("filter_selector_bumps", 0) > 0,
              "adaptive: the report waves bumped no selector")
    n_slots = kw["n_buckets"] * 4
    n_absent = on["acked"] // WAVE_CUT
    print(f"   {label}: {keys.size} insert lanes, {on['acked']} acknowledged "
          f"(load {on['acked'] / n_slots!r}), false positives "
          f"{int(on['hits'][on['acked']:].sum())} of {n_absent} absent "
          f"({on['reported']} reported), {n_del} of {n_absent} "
          f"deletes acknowledged, no false negatives", flush=True)
    print(f"   {label} counters: kick depth "
          f"{snap['filter_kick_depth']['counts']}, "
          + ", ".join(f"{k} {v}" for k, v in sorted(snap.items())
                      if k.startswith(("filter_probe_depth", "filter_stash",
                                       "filter_rollback", "filter_table",
                                       "filter_selector"))), flush=True)
    print(f"   {label} launches: off {off['launches']}, on {on['launches']}",
          flush=True)
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    for name, arm in arms.items():
        dev_s, t_wall = busy[name]
        print(f"   [{card}] {label}, telemetry {name}: "
              f"{' / '.join(repr(w) for w in walls[name])} s wall, "
              f"{arm['waves'] / wall[name]!r} waves/s, "
              f"{arm['keys'] / wall[name]!r} keys/s (the median); traced "
              f"run: "
              f"device busy {dev_s!r} s of {t_wall!r} s (idle share "
              f"{1 - dev_s / t_wall!r})", flush=True)
    overhead = (wall["on"] - wall["off"]) / wall["off"] * 100
    dev_over = ((busy["on"][0] - busy["off"][0]) / busy["off"][0] * 100
                if busy["off"][0] > 0 else None)
    print(f"   [{card}] {label} telemetry overhead: {overhead!r} % of the "
          f"wall, {dev_over!r} % of the device's busy time", flush=True)
    return {"launches": on["launches"],
            "plain": dict(plain),
            "overhead_pct": overhead, "busy": busy, "wall": walls}


def filter_wave_path(card: str, *, n_buckets=1 << 20, wave=4096,
                     stash_slots=128, load=0.85) -> dict:
    """The filter's serving front at full size: one node's membership
    filter (2^20 buckets of 4, the 16 MB table of phase 4's 2^22 slots,
    fp_bits 16, a 128-slot stash, the eviction budget of load 0.85) behind
    ``FilterOpBatcher`` (4096-key waves, double-buffered): seeded insert
    waves up to load 0.85, lookups of every acknowledged key and as many
    absent ones, deletes of half the acknowledged keys; the same over the
    four adaptive planes with report waves of the false positives
    (``filter_wave_family``)."""
    rng = np.random.RandomState(SEED + 19)
    keys = random_keys(rng, int(load * n_buckets * 4))
    absent = random_keys(rng, keys.size)
    print(f"   depth cut: absent lookups and deletes 1/{WAVE_CUT} of the "
          f"acknowledged keys (were 1 and 1/2), repeated arms "
          f"{WAVE_REPEATS} (were on, off, off, on)", flush=True)
    kw = dict(n_buckets=n_buckets, wave=wave, stash_slots=stash_slots,
              load=load)
    out = {"launches": {}, "plain": {}, "families": {}}
    for adaptive in (False, True):
        fam = filter_wave_family(card, adaptive, keys, absent, **kw)
        out["launches"].update(fam["launches"])
        for k, v in fam["plain"].items():
            out["plain"][k] = out["plain"].get(k, 0) + v
        out["families"]["adaptive" if adaptive else "static"] = fam
    return out


# ------------------------------------- phase 5e: SLO scenarios at node size --

# Each scenario at one node's filter: the reference's stack and wave size
# (repro/serving/slo.py:272-283, 512-key waves) with n_buckets and
# wave_slots scaled by one factor; stash sizes, fp_bits, TTL and the
# admission band stay the reference's.  name: (make_batcher kwargs, wave).
SLO_NODE = {
    "uniform": (dict(n_buckets=1 << 20), 1 << 17),
    "zipfian": (dict(n_buckets=1 << 20), 1 << 17),
    "burst_train": (dict(n_buckets=1 << 20, stash_slots=64), 1 << 18),
    "delete_heavy": (dict(n_buckets=1 << 20), 1 << 18),
    "adversarial": (dict(n_buckets=1 << 20), 1 << 18),
}
# ttl_churn: the reference's ring (4 generations of 4096 slots, ttl 3.0) at
# phase 5b's 2^22 slots a generation.
SLO_RING = dict(generations=4, capacity=1 << 22, fp_bits=16, ttl=3.0)
SLO_RING_WAVE = 1 << 19
# The admission arm: the reference's 1024 buckets and 32-slot stash with
# the band 0.18 / 0.12, double-buffered.
SLO_ADMISSION = (dict(n_buckets=1 << 20, stash_slots=32), 1 << 19)
SLO_BAND = (0.18, 0.12)
# Phase 5e's depth: half the reference's waves of each scenario whose
# checks do not count rounds (adversarial keeps its four rounds); the
# stacks, wave widths and the telemetry mode's sizes stay.
SLO_DEPTH = {"uniform": dict(waves=24), "zipfian": dict(waves=24),
             "delete_heavy": dict(waves=18), "burst_train": dict(bursts=3),
             "ttl_churn": dict(waves=18)}
SLO_KERNELS = ("probe", "insert_bulk", "delete_bulk", "probe_adaptive",
               "insert_bulk_adaptive", "fingerprint_hash_family",
               "probe_multi", "fingerprint_hash", "probe_tm",
               "insert_bulk_tm", "probe_adaptive_tm",
               "insert_bulk_adaptive_tm")


def device_busy_s(prof) -> float:
    """Device time summed over a CUDA-activity profile, in seconds."""
    return sum((getattr(ev, "device_time_total", 0.0) or 0.0)
               for ev in prof.key_averages()) / 1e6


def replay(h, run, trace: bool):
    """``run()`` -> its report; with ``trace``, under a CUDA-activity
    profile whose device busy time lands in ``h.busy_s``."""
    if not trace:
        return run()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = run()
    h.busy_s = device_busy_s(prof)
    return rep


def slo_arm(name: str, *, stack: dict, wave: int, label=None,
            double_buffer="auto", admission=None, trace: bool = False):
    """One batcher arm of phase 5e: a fresh stack from ``make_batcher``,
    warmed on a throwaway stack of the same shape, then the scenario's
    default stream through ``SloHarness().run`` (with ``trace``, under a
    profile) -> (report, recording)."""
    import torch
    from repro_torch.serving.slo import _warm_batcher, make_batcher
    from repro_torch.serving.workloads import scenario_stream
    t0 = time.perf_counter()
    stream = scenario_stream(name, SEED, wave_slots=wave,
                             **SLO_DEPTH.get(name, {}))
    t1 = time.perf_counter()
    b = make_batcher(name, wave_slots=wave, double_buffer=double_buffer,
                     admission=admission, **stack)
    kinds = {x.kind for x in stream}
    if any(x.feedback for x in stream):
        kinds.add("report")
    _warm_batcher(b, kinds)
    h = slo_recorder()
    gc.collect()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rep = replay(h, lambda: h.run(b, stream, scenario=label or name), trace)
    print(f"   {label or name}: stream built in {t1 - t0!r} s, stack and "
          f"warm-up {t2 - t1!r} s, replay {time.perf_counter() - t2!r} s",
          flush=True)
    return rep, h


def filter_signatures(keys: np.ndarray, fp_bits: int, n_buckets: int):
    """uint64 per key: its fingerprint and unordered bucket pair, the slots
    a delete of it could clear (``core.hashing``'s numpy twins)."""
    from repro_torch.core.hashing import (alt_index_np, fingerprint_np,
                                          index_hash_np, key_to_u32_pair_np)
    hi, lo = key_to_u32_pair_np(keys)
    fp = fingerprint_np(hi, lo, fp_bits).astype(np.uint64)
    i1 = index_hash_np(hi, lo, n_buckets).astype(np.uint64)
    i2 = alt_index_np(i1.astype(np.uint32), fp.astype(np.uint32),
                      n_buckets).astype(np.uint64)
    return ((fp << np.uint64(42)) | (np.minimum(i1, i2) << np.uint64(21))
            | np.maximum(i1, i2))


class KeyIds:
    """Ids of the keys a run inserted (sorted, distinct); -1 for others."""

    def __init__(self, inserted: list):
        self.keys = (np.unique(np.concatenate(inserted)) if inserted
                     else np.zeros(0, np.uint64))

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        out = np.full(keys.size, -1, np.int64)
        if not self.keys.size:
            return out
        # sorted queries walk the sorted keys in order (5x faster than
        # random ones at millions of keys)
        order = np.argsort(keys)
        sk = keys[order]
        pos = np.searchsorted(self.keys, sk)
        pos[pos == self.keys.size] = 0
        out[order] = np.where(self.keys[pos] == sk, pos, -1)
        return out


def batcher_false_negatives(h, *, fp_bits: int) -> dict:
    """Check (b) of phase 5e for a batcher arm, from the waves' own results
    in launch order: a key an insert wave acknowledged, and no acknowledged
    delete has removed since, must answer True in every lookup wave, and
    again in lookups of every such key after the run.  An acknowledged
    delete of a key that is not held (a shed insert's key, under
    admission) may clear a held key's entry with the same fingerprint and
    buckets; such keys are exempt, and counted."""
    t0 = time.perf_counter()
    b = h.target
    n_buckets = int(b.state.n_buckets)
    ids = KeyIds([k for w, k in h.launched if w.kind == "insert"])
    held = np.zeros(ids.keys.size, bool)
    exempt = np.zeros(ids.keys.size, bool)
    sigs = None
    fn = checked = stray = 0
    for wave, keys in h.launched:
        res = wave.results
        if wave.kind == "insert":
            held[ids(keys[res])] = True
        elif wave.kind == "delete":
            gone = ids(keys[res])
            wild = keys[res][(gone < 0) | ~held[np.maximum(gone, 0)]]
            if wild.size:
                stray += wild.size
                if sigs is None:
                    sigs = filter_signatures(ids.keys, fp_bits, n_buckets)
                exempt |= np.isin(sigs, filter_signatures(wild, fp_bits,
                                                          n_buckets))
            held[gone[gone >= 0]] = False
        elif wave.kind == "lookup":
            i = ids(keys)
            need = (i >= 0) & held[np.maximum(i, 0)] & ~exempt[np.maximum(
                i, 0)]
            checked += int(need.sum())
            fn += int((need & ~res).sum())
    # The final lookups go through a second batcher over the same state
    # (lookups change nothing), so the recorded one keeps its parked waves.
    members = ids.keys[held & ~exempt]
    h.members = members
    probe = type(b)(b.ops, b.state, stash=b.stash, wave_slots=b.wave_slots)
    after = [probe.submit("lookup", members[i:i + b.wave_slots])
             for i in range(0, members.size, b.wave_slots)]
    probe.flush()
    fn_after = int(sum((~w.results).sum() for w in after))
    return {"fn": fn, "checked": checked, "fn_after": fn_after,
            "held": int(members.size), "stray_deletes": stray,
            "exempt": int((held & exempt).sum()),
            "check_s": time.perf_counter() - t0}


def ring_false_negatives(h) -> dict:
    """Check (b) for the ring: a key an insert acknowledged must answer
    True at a lookup while the generation it went into is in the ring and
    live at the lookup's clock (an insert call that rotated is not
    counted: its keys may have gone into either generation)."""
    t0 = time.perf_counter()
    ins = [w for w in h.waves if w[0] == "insert"]
    ids = KeyIds([w[1] for w in ins])
    owner = np.full(ids.keys.size, -1, np.int64)
    gens: list = []
    fn = checked = skipped = 0
    for kind, keys, out, extra, _now in h.waves:
        if kind == "insert":
            if extra is None:
                skipped += int(out.sum())
                continue
            owner[ids(keys[out])] = len(gens)
            gens.append(extra)
        else:
            alive = np.array([any(g is x for x in extra) for g in gens]
                             + [False])
            o = owner[ids(keys)]
            need = alive[o] & (o >= 0)
            checked += int(need.sum())
            fn += int((need & ~out).sum())
    return {"fn": fn, "checked": checked, "skipped_inserts": skipped,
            "check_s": time.perf_counter() - t0}


def slo_rows(rows: dict, rep, name: str) -> None:
    rows.update(rep.rows(f"slo_{name}"))
    rows[f"slo_{name}_waves"] = rep.waves
    rows[f"slo_{name}_wall_s"] = rep.wall_s


def slo_node_path(card: str) -> dict:
    """Phase 5e: every scenario at node size (``SLO_NODE``, ``SLO_RING``,
    ``SLO_ADMISSION``), each with its own mix, hit blend, burst pattern
    and load trajectory, composed from ``make_batcher``, ``SloHarness``
    and ``GenerationalFilter``; the burst train through the sync arm and
    the default path (the async arm on a card); the scenario harness's
    telemetry mode at the reference's size, card against CPU; ``uniform``
    once more under a CUDA trace for the device's idle share.  Checks:
    (a) the sync and async arms equal bit for bit; (b) no false negatives;
    (c) adversarial's false positives shrink from the first round to the
    last; (d) ttl_churn's ring turns over and expires; (e) the admission
    arm defers and its signal reaches high water; (f) every kernel of
    ``SLO_KERNELS`` launched; (g) no plain version ran."""
    import tempfile

    import torch
    from repro_torch.kernels import cuda
    from repro_torch.serving.slo import (_warm_generational,
                                         run_scenario_telemetry)
    from repro_torch.serving.workloads import scenario_stream
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    from repro_torch.streaming.admission import AdmissionConfig

    torch.cuda.synchronize()
    cuda.reset_counts()
    rows: dict = {"slo_seed": SEED}
    print(f"   depth cut to {SLO_DEPTH} (the reference's: uniform and "
          f"zipfian 48 waves, delete_heavy and ttl_churn 36, burst_train 6 "
          f"bursts)", flush=True)

    def counted(label, fn):
        before = collections.Counter(cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        delta = dict(collections.Counter(cuda.LAUNCHES) - before)
        print(f"   [{card}] {label}: {took!r} s with warm-up and checks "
              f"(checks {out[-1].get('check_s')!r} s), launches {delta}",
              flush=True)
        return out

    def report(label, rep, fn_stats):
        p = rep.percentiles_us
        print(f"   [{card}] {label}: {rep.waves} waves, {rep.ops} ops in "
              f"{rep.wall_s!r} s ({rep.keys_per_s!r} keys/s, "
              f"{rep.waves / rep.wall_s!r} waves/s); p50 {p['p50']!r} us, "
              f"p99 {p['p99']!r} us, p99.9 {p['p999']!r} us; per kind "
              f"{rep.per_kind}; extras {rep.extras}; shed {rep.shed_ops}, "
              f"deferred waves {rep.deferred_waves}, held ticks "
              f"{rep.held_ticks}; false negatives {fn_stats}", flush=True)
        check(fn_stats["fn"] == 0 and fn_stats.get("fn_after", 0) == 0,
              f"{label}: false negatives {fn_stats}")

    for name in ("uniform", "zipfian", "delete_heavy", "adversarial"):
        stack, wave = SLO_NODE[name]

        def arm(name=name, stack=stack, wave=wave):
            rep, h = slo_arm(name, stack=stack, wave=wave)
            fps = 8 if name == "adversarial" else 16
            return rep, h, batcher_false_negatives(h, fp_bits=fps)
        rep, h, fn_stats = counted(name, arm)
        report(name, rep, fn_stats)
        slo_rows(rows, rep, name)
        if name == "uniform":
            # phase 6 times probe on this node's final state
            node = {"table": h.target.state.table.clone(),
                    "n_buckets": int(h.target.state.n_buckets),
                    "stash": h.target.stash.clone(), "resident": h.members}
        if name == "adversarial":
            looks = [w for k, _keys, w in h.waves if k == "lookup"]
            pool = len(looks) // 4
            rounds = [int(sum(w.results.sum() for w in looks[i:i + pool]))
                      for i in range(0, len(looks), pool)]
            print(f"   adversarial false positives by round: {rounds} of "
                  f"{sum(w.n for w in looks[:pool])} pool keys", flush=True)
            check(rounds[-1] < rounds[0],
                  f"adversarial: false positives did not shrink: {rounds}")
        del h

    # (a) the burst train through the sync arm and the default path, which
    # on a card is the async (double-buffered) arm: one run serves both
    arms = {}
    for label, flag in (("sync", False), ("async", "auto")):
        stack, wave = SLO_NODE["burst_train"]

        def arm(flag=flag, stack=stack, wave=wave, label=label):
            rep, h = slo_arm("burst_train", stack=stack, wave=wave,
                             double_buffer=flag)
            # the async arm's answers are held equal to the sync arm's
            # below, so one false-negative check serves both
            return rep, h, (batcher_false_negatives(h, fp_bits=16)
                            if label == "sync"
                            else {"fn": 0, "as": "the sync arm"})
        rep, h, fn_stats = counted(f"burst_train {label}", arm)
        report(f"burst_train {label}", rep, fn_stats)
        for pname, v in rep.percentiles_us.items():
            rows[f"slo_burst_train_{label}_{pname}_us"] = round(v, 1)
        rows[f"slo_burst_train_{label}_wall_s"] = rep.wall_s
        arms[label] = h
        if label == "async":
            check(h.target.double_buffer, "the default submit path on the "
                                          "card is not double-buffered")
            rows["slo_submit_double_buffered"] = 1
            slo_rows(rows, rep, "burst_train")
    check(slo_same_waves(arms["sync"], arms["async"])
          and slo_same_stack(arms["sync"].target, arms["async"].target),
          "burst_train: the sync and async arms differ")
    print("   burst_train: sync and async arms equal bit for bit (every "
          "wave, the final table, stash and count)", flush=True)
    del arms

    # ttl_churn on phase 5b's ring at ttl 3.0
    def ring_arm(trace=False):
        cfg = GenerationConfig(**SLO_RING)
        stream = scenario_stream("ttl_churn", SEED, wave_slots=SLO_RING_WAVE,
                                 **SLO_DEPTH["ttl_churn"])
        _warm_generational(cfg)
        h = slo_recorder()
        gc.collect()
        torch.cuda.synchronize()
        rep = replay(h, lambda: h.run_generational(
            GenerationalFilter(config=cfg, now=0.0), stream,
            scenario="ttl_churn"), trace)
        return rep, h

    def checked_ring_arm():
        rep, h = ring_arm()
        return rep, h, ring_false_negatives(h)
    rep, h, fn_stats = counted("ttl_churn", checked_ring_arm)
    report("ttl_churn", rep, fn_stats)
    slo_rows(rows, rep, "ttl_churn")
    born = sorted({w[3].born for w in h.waves
                   if w[0] == "insert" and w[3] is not None})
    print(f"   ttl_churn: generations born at {born}, stats "
          f"{h.target.stats}", flush=True)
    check(rep.extras["expirations"] >= 1 and len(born) >= 2,
          f"ttl_churn: the ring did not turn over and expire ({born}, "
          f"{rep.extras})")
    del h

    # (e) the admission arm
    hi_w, lo_w = SLO_BAND

    def admission_arm():
        stack, wave = SLO_ADMISSION
        rep, h = slo_arm(
            "burst_train", stack=stack, wave=wave, label="burst_admission",
            double_buffer=True,
            admission=AdmissionConfig(high_water=hi_w, low_water=lo_w))
        return rep, h, batcher_false_negatives(h, fp_bits=16)
    rep, h, fn_stats = counted("burst_admission", admission_arm)
    report("burst_admission", rep, fn_stats)
    admitted = rep.recorder.percentiles(exclude_deferred=True)
    readmitted = sum(1 for x in rep.recorder.samples if x.deferred)
    rows["slo_burst_admission_p99_us"] = round(admitted["p99"], 1)
    rows["slo_burst_admission_shed_ops"] = rep.shed_ops
    rows["slo_burst_admission_deferred_waves"] = rep.deferred_waves
    rows["slo_burst_admission_peak_signal"] = rep.extras.get(
        "peak_signal", 0.0)
    rows["slo_burst_admission_readmitted_waves"] = readmitted
    rows["slo_burst_admission_waves"] = rep.waves
    rows["slo_burst_admission_wall_s"] = rep.wall_s
    print(f"   burst_admission: admitted-op p99 {admitted['p99']!r} us, "
          f"{rep.deferred_waves} waves deferred, {readmitted} re-admitted "
          f"(not fatal), {rep.shed_ops} ops shed, peak signal "
          f"{h.target.admission.peak_signal!r}", flush=True)
    check(rep.deferred_waves >= 1
          and h.target.admission.peak_signal >= hi_w,
          "burst_admission: the gate never deferred a wave or its signal "
          "never reached high water")
    del h

    # the harness's telemetry mode at the reference's sizes; its CPU runs
    # come after the launch counts are read
    def telemetry(device: str, tmp: str) -> dict:
        out = {}
        for name in ("uniform", "adversarial"):
            _rep, paths = run_scenario_telemetry(
                name, f"{tmp}/{device}", device=device, double_buffer=True)
            check(Path(paths["trace"]).stat().st_size > 0,
                  f"telemetry {name}: no trace written")
            with open(paths["metrics"]) as f:
                out[name] = [{k: v for k, v in json.loads(x).items()
                              if k != "ts"} for x in f]
            out[name] = [x for x in out[name] if x["type"] != "wave"
                         and "latency" not in x["metric"]]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tm_card = telemetry("cuda", tmp)

    # where the time goes: every arm's replay once more, under a trace
    adm = dict(label="burst_admission", double_buffer=True,
               admission=AdmissionConfig(high_water=hi_w, low_water=lo_w))
    for label, run in (
            *((n, lambda n=n: slo_arm(n, stack=SLO_NODE[n][0],
                                      wave=SLO_NODE[n][1], trace=True))
              for n in ("uniform", "zipfian", "delete_heavy", "adversarial",
                        "burst_train")),
            ("ttl_churn", lambda: ring_arm(trace=True)),
            ("burst_admission", lambda: slo_arm(
                "burst_train", stack=SLO_ADMISSION[0],
                wave=SLO_ADMISSION[1], trace=True, **adm))):
        traced, h = run()
        idle = 1 - h.busy_s / traced.wall_s
        rows[f"slo_{label}_traced_idle_share"] = idle
        print(f"   [{card}] {label} traced: device busy {h.busy_s!r} s of "
              f"{traced.wall_s!r} s (idle share {idle!r})", flush=True)
        del h

    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    missing = [k for k in SLO_KERNELS if not launches.get(k)]
    check(not missing, f"phase 5e never launched {missing}")
    with tempfile.TemporaryDirectory() as tmp:
        tm_cpu = telemetry("cpu", tmp)
    for name, series in tm_card.items():
        check(series == tm_cpu[name],
              f"telemetry {name}: the counters differ, card vs CPU")
        print(f"   telemetry mode {name}: {len(series)} metric series, "
              f"same as the CPU", flush=True)
    return {"rows": rows, "launches": launches, "plain": plain, "node": node}


# --------------------------------------------- phase 5b: the streaming path --


def streaming_path(card: str, *, ticks=32, base=600_000, burst=4,
                   burst_ticks=(8, 9, 10, 11), window=4):
    """The dedup stage of one node (examples/streaming_dedup.py at scale):
    per tick of a logical clock, ``new = ~lookup(events)`` then
    ``insert(events[new])``; 60% of a tick's events are fresh 64-bit ids,
    40% repeat ids drawn from the fresh ids of the previous ``window``
    ticks (tick 0 repeats its own).  Then the TTL step."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.streaming import GenerationalFilter, GenerationConfig
    from torch.profiler import ProfilerActivity, profile

    cfg = GenerationConfig(**RING)
    rng = np.random.RandomState(SEED + 6)
    gf = GenerationalFilter(cfg, now=0.0)

    ring_pool = gf.pool

    def pool_ptrs():
        return ring_pool.tables.data_ptr(), ring_pool.stashes.data_ptr()

    def in_pool():
        return all(g.state.table.data_ptr()
                   == ring_pool.tables[g.slot].data_ptr()
                   and g.stash.array.data_ptr()
                   == ring_pool.stashes[g.slot].data_ptr() for g in gf.gens)

    ptrs = pool_ptrs()
    every_in_pool = True
    times = {"lookup": 0.0, "insert": 0.0}
    n_probe = n_ins = n_fresh = fresh_flagged = 0
    fn = missed_unheld = repeats_checked = 0
    all_ok = True
    fresh_hist, held_hist, inserted = [], [], []

    def timed(name, fn_):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn_()
        torch.cuda.synchronize()
        times[name] += time.perf_counter() - t0
        return out

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_counts()
        for t in range(ticks):
            n = base * (burst if t in burst_ticks else 1)
            fresh = random_keys(rng, int(n * 0.6))
            if t == 0:
                pool, pool_held = fresh, None
            else:
                pool = np.concatenate(fresh_hist[-window:])
                pool_held = np.concatenate(held_hist[-window:])
            pick = rng.randint(0, pool.size, n - fresh.size)
            events = np.concatenate([fresh, pool[pick]])
            new = ~timed("lookup", lambda: gf.lookup(events, now=float(t)))
            ok = timed("insert", lambda: gf.insert(events[new],
                                                   now=float(t)))
            all_ok &= bool(ok.all())
            n_probe += events.size
            n_ins += int(new.sum())
            inserted.append(events[new][ok])
            fresh_new = new[: fresh.size]
            held = np.zeros(fresh.size, bool)  # in the filter from now on
            held[fresh_new] = ok[: int(fresh_new.sum())]
            n_fresh += fresh.size
            fresh_flagged += int((~fresh_new).sum())
            if t >= 1:
                found = ~new[fresh.size:]
                was_held = pool_held[pick]
                repeats_checked += int(was_held.sum())
                fn += int((was_held & ~found).sum())
                missed_unheld += int((~was_held & ~found).sum())
            fresh_hist.append(fresh)
            held_hist.append(held)
            every_in_pool &= in_pool()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base_bytes
        live = gf._live(float(ticks - 1))
        # A copy for phase 6 (the TTL step below zeroes the pool).
        snap = (ring_pool.tables.clone(), ring_pool.stashes.clone(),
                [g.slot for g in live], cfg.n_buckets)
        stats_end = dataclasses.replace(gf.stats)
        # The TTL step: every generation has expired by now.
        now_end = float(ticks - 1) + RING["ttl"] + 1.0
        every = np.concatenate(inserted)
        stale_hits = int(gf.lookup(every, now=now_end).sum())
        n_gens, exp0 = len(gf.gens), gf.stats.expirations
        retired = gf.advance(now=now_end)
        expired = gf.stats.expirations - exp0
        torch.cuda.synchronize()
        launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)

    device_s = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or 0.0
        if us > 0:
            device_s[ev.key] = device_s.get(ev.key, 0.0) + us / 1e6
    fp_share = fresh_flagged / n_fresh
    fp_bound = (4 * RING["generations"] * 2 * RING["bucket_size"]
                * RING["o_max"] / 2 ** RING["fp_bits"])
    wall = sum(times.values())
    busy = sum(device_s.values())
    print(f"   stats at the end of the stream={stats_end} live generations="
          f"{len(live)}", flush=True)
    print(f"   [{card}] dedup probe {n_probe / times['lookup']!r} keys/s "
          f"({n_probe} keys, {times['lookup']!r} s), insert "
          f"{n_ins / times['insert']!r} keys/s ({n_ins} keys, "
          f"{times['insert']!r} s)", flush=True)
    print(f"   fresh ids flagged as duplicates: {fresh_flagged} of {n_fresh}"
          f" (share {fp_share!r}, bound {fp_bound!r}); repeats of held ids "
          f"{repeats_checked}, missed {fn}; repeats of ids never held "
          f"(flagged when fresh) missed: {missed_unheld}", flush=True)
    print(f"   TTL step at now={now_end}: hits of {every.size} inserted ids "
          f"{stale_hits}; advance retired {retired} of {n_gens}, "
          f"expirations +{expired}", flush=True)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    print(f"   device memory over the ring's pool during the ticks: peak "
          f"{transient} B (the pool's tables: "
          f"{ring_pool.tables.numel() * 4} B)",
          flush=True)
    print(f"   [{card}] device busy {busy!r} s of {wall!r} s of phases "
          f"(idle share {1 - busy / wall!r})", flush=True)
    for kernel, name in (("probe_multi_kernel", "lookup"),
                         ("insert_kernel", "insert"),
                         ("fingerprint_kernel", "insert")):
        k_s = sum(v for key, v in device_s.items() if kernel in key)
        print(f"   {kernel}: {k_s!r} s on the device, {k_s / times[name]!r} "
              f"of the {name} phase ({times[name]!r} s)", flush=True)

    check(fn == 0, f"{fn} repeats of held ids were not found")
    check(fp_share <= fp_bound, f"fresh-flagged share {fp_share} > "
                                f"{fp_bound}")
    check(stats_end.rotations >= 4, f"only {stats_end.rotations} rotations")
    check(pool_ptrs() == ptrs and every_in_pool,
          "a generation's table or stash left the ring's pool")
    # A copy of the live tables (what a stacked fan-out input would cost)
    # would not fit under this: the ticks' keys and answers do.
    check(transient < ring_pool.tables.numel() * 4,
          f"{transient} B of device memory over the pool during the ticks")
    check(all_ok, "an insert was not acknowledged")
    check(stale_hits == 0, f"{stale_hits} hits after every TTL expired")
    check(retired == n_gens and expired == n_gens,
          f"advance retired {retired} and expired {expired} of {n_gens}")
    return snap, inserted[-1], launches, plain, {
        "times": times, "device_s": device_s, "fp_share": fp_share}


def kernel_class(name: str) -> str:
    """"flash", "matmul" or "other" by a device kernel's name."""
    key = name.lower()
    return ("flash" if "flash_" in key else "matmul"
            if any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma"))
            else "other")


def class_trace(fn) -> tuple[float, dict, int]:
    """One call of ``fn`` under a CUDA-activity ``torch.profiler`` trace
    -> (host ms, device ms by ``kernel_class``, device kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = 0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0) or 0.0
        if us <= 0 or ev.key.startswith("aten::"):
            continue
        kernels += ev.count
        by[kernel_class(ev.key)] += us / 1e3
    return wall * 1e3, by, kernels


def lm_profile(model, toks, card: str, *, prompt: int = 1024,
               steps: int = 3) -> dict:
    """Where the LM path's time goes, from CUDA-activity ``torch.profiler``
    traces: one cache-less forward over ``toks`` (device time of the flash
    kernel, of the matrix products and of everything else; the idle share
    of the host clock), then ``steps`` greedy decode steps after a
    ``prompt``-token prefill in a float32 cache (device kernels launched
    and device busy time per step, against the host clock)."""
    import torch
    trace = class_trace
    wall, by, _n = trace(lambda: model.apply(toks))
    busy = sum(by.values())
    print(f"   (a) profile of one forward [{card}]: {wall!r} ms host clock, "
          f"device busy {busy!r} ms (flash {by['flash']!r}, matrix products"
          f" {by['matmul']!r}, other {by['other']!r}), idle share "
          f"{1 - busy / wall!r}", flush=True)
    cache = model.init_cache(1, prompt + steps + 1, dtype=torch.float32)
    model.apply(toks[:, :prompt], cache=cache, cache_pos=0)
    tok = toks[:, prompt:prompt + 1]

    def decode():
        for pos in range(prompt, prompt + steps):
            int(model.decode_step(cache, tok, pos).logits[0, 0].argmax())
    dwall, dby, dn = trace(decode)
    dbusy = sum(dby.values())
    print(f"   (a) profile of {steps} decode steps [{card}]: "
          f"{dwall / steps!r} ms a step host clock, {dn / steps!r} device "
          f"kernels a step, device busy {dbusy / steps!r} ms a step "
          f"(matrix products {dby['matmul'] / steps!r}), idle share "
          f"{1 - dbusy / dwall!r}", flush=True)
    return {"forward_ms": wall, "forward_device_ms": by,
            "decode_ms": dwall / steps, "decode_kernels": dn / steps,
            "decode_device_ms": dbusy / steps}


# -------------------------------------------- phase 5c: the LM serving path --


def lm_path(card: str, *, seq: int = LM_SEQ, check_seq: int = 1024,
            requests: int = 16, prefix_len: int = 1008, block: int = 16,
            gen: int = 16):
    """The LM path of gemma3-1b at full size (26 layers, full width, float32
    weights from SEED): (a) a cache-less forward over ``seq`` tokens in
    bfloat16 (prompt scoring: 22 local and 4 global flash launches); (b)
    the serving consistency check of tests/test_models.py in float32: the
    last position's log-softmax from the flash forward against the cached
    prefill + one decode step (blockwise attention) of the same
    ``check_seq``-token prompt, within 1e-3; (c) ``serve()`` of the port,
    ``requests`` prompts of ``prefix_len + block`` tokens, ``gen`` tokens
    each, through the OCF prefix-cache index."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import Transformer

    cfg = get_config(LM_ARCH)
    rng = np.random.RandomState(SEED + 11)
    torch.cuda.synchronize()
    cuda.reset_counts()
    out = {}

    # (a) prompt scoring
    model = Transformer(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).cuda()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.apply(toks).logits
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    flash_per_forward = cuda.LAUNCHES["flash_attention"] // len(times)
    out["forward_s"] = min(times)
    print(f"   (a) {cfg.name}: {n_params} parameters, forward over {seq} "
          f"tokens {times!r} s -> {seq / min(times)!r} tokens/s [{card}]; "
          f"logits {shape} finite={finite}; flash launches per forward "
          f"{flash_per_forward}", flush=True)
    check(finite and shape == (1, seq, cfg.vocab_size),
          "the prompt-scoring logits are not finite or of the wrong shape")
    check(flash_per_forward == cfg.n_layers,
          f"{flash_per_forward} flash launches per forward, not "
          f"{cfg.n_layers}")
    out["forward_profile"] = lm_profile(model, toks, card)
    torch.cuda.synchronize()
    bf16_launches = cuda.LAUNCHES["flash_attention"]
    del model
    torch.cuda.empty_cache()

    # (b) the flash forward against the cached serving path, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Transformer(cfg32, seed=SEED, device="cuda")
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (1, check_seq))).cuda()
    full = model.apply(toks).logits[:, -1]
    cache = model.init_cache(1, check_seq + 4, dtype=torch.float32)
    model.apply(toks[:, :-1], cache=cache, cache_pos=0)
    dec = model.decode_step(cache, toks[:, -1:], check_seq - 1).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    out["serving_err"] = err
    f32_launches = cuda.LAUNCHES["flash_attention"] - bf16_launches
    print(f"   (b) flash forward vs cached prefill + decode, float32, "
          f"S={check_seq}: log-softmax max err {err!r}", flush=True)
    print(f"   flash launches: {bf16_launches} bfloat16 (flash_wgmma_kernel,"
          f" a), {f32_launches} float32 (flash_f32_kernel, b)", flush=True)
    check(err < 1e-3, f"the flash forward and the cached serving path "
                      f"differ by {err}")
    del model, cache
    torch.cuda.empty_cache()

    # (c) the server
    res = serve(LM_ARCH, requests=requests, prefix_len=prefix_len, gen=gen,
                smoke=False, seed=SEED, block=block, device="cuda")
    out["serve"] = res
    print(f"   (c) serve {requests} requests x ({prefix_len} + {block} "
          f"prompt, {gen} generated): latency mean "
          f"{res['latency_mean_s']!r} s p99 {res['latency_p99_s']!r} s, "
          f"prefill {res['prefill_tokens_per_s']!r} tokens/s, decode "
          f"{res['decode_tokens_per_s']!r} tokens/s, prefix hit rate "
          f"{res['prefix_hit_rate']!r}, reused blocks "
          f"{res['reused_blocks']}, index {res['index_stats']} [{card}]",
          flush=True)
    check(res["reused_blocks"] > 0, "serve reused no prefix block")
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    return launches, plain, out


def lm_batcher_path(card: str, *, requests: int = 8, prefix_len: int = 1008,
                    block: int = 16, gen: int = 8, slots: int = 4,
                    cache_len: int = 1040):
    """Phase 5c (d): ``ContinuousBatcher`` over gemma3-1b at full size (26
    layers, full width, float32 weights from SEED, as (a) builds it): a
    burst of ``requests`` prompts of ``prefix_len + block`` tokens (half
    share the system prompt, as ``serve()`` builds them) into ``slots``
    slots, ``gen`` tokens each, a float32 cache of ``cache_len`` a slot and
    the OCF prefix index.  Each request's tokens must equal
    ``engine.generate`` of its prompt on the card; ``SchedStats`` must
    equal those of the same stream through the batcher on the CPU over a
    2-layer smoke model of the same vocabulary (the counts do not depend on
    the depth); the queue must exceed the slots after the burst."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import request_prompts
    from repro_torch.models import Transformer
    from repro_torch.serving import ContinuousBatcher, Request
    from repro_torch.serving.engine import generate

    cfg = get_config(LM_ARCH)
    prompts = request_prompts(np.random.RandomState(SEED), cfg.vocab_size,
                              requests=requests, prefix_len=prefix_len,
                              block=block)

    def burst(model):
        b = ContinuousBatcher(model, slots=slots, cache_len=cache_len,
                              block=block)
        reqs = [Request(rid=i, prompt=p, max_new=gen)
                for i, p in enumerate(prompts)]
        return b, reqs

    model = Transformer(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    cuda.reset_counts()
    b, reqs = burst(model)
    t0 = time.perf_counter()
    for r in reqs:
        b.submit(r)
    congestion = b.congestion
    done, decode_ticks = {}, []
    while b.queue or b.active:
        prefills = b.stats.prefills
        t1 = time.perf_counter()
        live = b.step()
        t2 = time.perf_counter()
        if b.stats.prefills == prefills:
            decode_ticks.append((t2 - t1, live))
        for r in reqs:
            if r.rid not in done and len(r.out) >= gen:
                done[r.rid] = t2 - t0
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    lat = np.array([done[r.rid] for r in reqs])
    dec_s = sum(t for t, _ in decode_ticks)
    dec_toks = sum(n for _, n in decode_ticks)
    stats = dataclasses.asdict(b.stats)
    print(f"   (d) ContinuousBatcher [{card}]: {requests} requests x "
          f"({prefix_len} + {block} prompt, {gen} generated) into {slots} "
          f"slots: {wall!r} s, {requests / wall!r} requests/s, latency "
          f"mean {float(lat.mean())!r} s p99 "
          f"{float(np.percentile(lat, 99))!r} s (from the burst's "
          f"arrival), decode {dec_toks / dec_s!r} tokens/s ({dec_toks} "
          f"tokens in {len(decode_ticks)} ticks without a prefill), "
          f"congestion after the burst {congestion!r}", flush=True)
    print(f"   (d) stats {stats}, launches {launches}", flush=True)
    check(congestion > 1.0, f"(d) congestion {congestion} after the burst")
    for r in reqs:
        want = generate(model, torch.from_numpy(r.prompt)[None, :],
                        gen, cache_len=cache_len).tokens[0].cpu().tolist()
        check(r.out == want, f"(d) request {r.rid}: tokens {r.out} differ "
                             f"from generate's {want}")
    del b, model
    torch.cuda.empty_cache()
    small = dataclasses.replace(get_smoke_config(LM_ARCH), n_layers=2,
                                vocab_size=cfg.vocab_size, dtype="float32",
                                max_seq_len=cache_len)
    cb, creqs = burst(Transformer(small, seed=SEED, device="cpu"))
    for r in creqs:
        cb.submit(r)
    cpu_stats = dataclasses.asdict(cb.run_until_drained())
    check(stats == cpu_stats, f"(d) SchedStats differ from the CPU's: "
                              f"{stats} vs {cpu_stats}")
    check(stats["finished"] == requests
          and stats["prefix_blocks_reused"] > 0,
          "(d) the burst did not drain or reused no prefix block")
    print(f"   (d) tokens equal generate's for all {requests} requests; "
          f"SchedStats equal the CPU's (2-layer smoke model)", flush=True)
    return launches, plain, {"wall": wall, "latency_s": lat.tolist(),
                             "decode_tokens_per_s": dec_toks / dec_s}


# ------------------------------------- phase 5g: MoE + MLA at full size --

MOE_RANGES = ("moe.dispatch", "moe.experts", "moe.combine")


def device_split(prof) -> tuple[dict, float]:
    """Device ms of a CPU + CUDA trace by class -> (split, the device ms of
    every kernel in the trace).  The flash kernel (launched through
    ctypes, so tied to no op: read by name); MoE dispatch / combine, every
    kernel launched inside the ``moe.dispatch`` and ``moe.combine`` ranges
    of ``models/moe.py`` (router, routing, one-hots, their einsums); the
    expert products (``moe.experts``: the weights' bfloat16 casts, the
    einsums, the SiLU) as matrix products and the rest; the other matrix
    products; the other elementwise kernels and casts.  The split covers
    the flash kernel and the kernels the trace ties to an op."""
    from torch.autograd import DeviceType
    by = {"flash": 0.0, "moe_dispatch_combine": 0.0, "experts_matmul": 0.0,
          "experts_other": 0.0, "matmul": 0.0, "other": 0.0}
    total = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and ev.name not in MOE_RANGES:
            ms = (ev.time_range.end - ev.time_range.start) / 1e3
            total += ms
            if kernel_class(ev.name) == "flash":
                by["flash"] += ms
    stack = [(ev, None) for ev in prof.events()
             if ev.device_type == DeviceType.CPU and ev.cpu_parent is None]
    while stack:
        ev, rng = stack.pop()
        rng = ev.name if ev.name in MOE_RANGES else rng
        for k in getattr(ev, "kernels", []):
            kind = kernel_class(k.name)
            if kind == "flash":
                continue
            if rng == "moe.experts":
                kind = "experts_" + kind
            elif rng is not None:
                kind = "moe_dispatch_combine"
            by[kind] += k.duration / 1e3
        stack.extend((c, rng) for c in ev.cpu_children)
    return by, total


def moe_profile(model, toks, card: str, *, prompt: int = 512,
                steps: int = 3) -> dict:
    """Where 5g's time goes, from CPU + CUDA ``torch.profiler`` traces:
    one cache-less forward over ``toks`` (``device_split``; the idle share
    of the host clock), then ``steps`` greedy decode steps after a
    ``prompt``-token prefill into a float32 cache (kernels launched, device
    busy and host ms a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def trace(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        from torch.autograd import DeviceType
        n = sum(1 for ev in prof.events()
                if ev.device_type == DeviceType.CUDA
                and ev.name not in MOE_RANGES)
        return wall, prof, n

    wall, prof, _n = trace(lambda: model.apply(toks))
    by, total = device_split(prof)
    split = sum(by.values())
    print(f"   (a) profile of one forward [{card}]: {wall!r} ms host clock "
          f"(under the profiler), device busy {total!r} ms: flash "
          f"{by['flash']!r}, MoE dispatch / combine "
          f"{by['moe_dispatch_combine']!r}, expert products "
          f"{by['experts_matmul']!r} + their casts and SiLU "
          f"{by['experts_other']!r}, other matrix products "
          f"{by['matmul']!r}, other elementwise and casts {by['other']!r} "
          f"({split!r} ms of it classed); idle share {1 - total / wall!r}",
          flush=True)
    cache = model.init_cache(1, prompt + steps + 1, dtype=torch.float32)
    model.apply(toks[:, :prompt], cache=cache, cache_pos=0)
    tok = toks[:, prompt:prompt + 1]

    def decode():
        for pos in range(prompt, prompt + steps):
            int(model.decode_step(cache, tok, pos).logits[0, 0].argmax())
    dwall, dprof, dn = trace(decode)
    dby, dtotal = device_split(dprof)
    print(f"   (a) profile of {steps} decode steps [{card}]: "
          f"{dwall / steps!r} ms a step host clock (under the profiler), "
          f"{dn / steps!r} device kernels a step, device busy "
          f"{dtotal / steps!r} ms a step (MoE dispatch / combine "
          f"{dby['moe_dispatch_combine'] / steps!r}, expert products "
          f"{dby['experts_matmul'] / steps!r} + their casts and SiLU "
          f"{dby['experts_other'] / steps!r}, other matrix products "
          f"{dby['matmul'] / steps!r}, other elementwise and casts "
          f"{dby['other'] / steps!r}), idle share {1 - dtotal / dwall!r}",
          flush=True)
    return {"forward_ms": wall, "forward_device_ms": total,
            "forward_split_ms": by, "decode_ms": dwall / steps,
            "decode_kernels": dn / steps,
            "decode_device_ms": dtotal / steps}


def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def moe_path(card: str, *, seq: int = MOE_SEQ, check_seq: int = 1024,
             requests: int = 8, prefix_len: int = 496, block: int = 16,
             gen: int = 8) -> tuple[dict, dict, dict]:
    """Phase 5g, MoE + MLA at full size.  (a) deepseek-v2-lite-16b (27
    layers, full width, float32 weights from SEED, bfloat16 activations):
    a cache-less forward over ``seq`` tokens (16 routing groups of 512;
    each layer's MLA through the padded flash kernel), 3 repeats, tokens/s,
    flash launches a forward (27), peak device memory, ``moe_profile``.
    (b) float32, TF32 off: the serving consistency check of
    tests/test_models.py, the last position's log-softmax of the flash
    forward over ``check_seq`` tokens against a cached prefill of 512 and
    then 511 tokens (the non-absorbed MLA path) and one decode step (the
    absorbed path, exact routing), within 1e-3; at a capacity of the whole
    group (capacity factor E / k: no token drops, as the reference's smoke
    configs have it for that check), since a forward and an exact decode
    step route the last token differently by design wherever its expert
    is full.  (b') At the config's own capacity factor, the flash forward
    against a cached prefill of the same ``check_seq`` tokens (the same
    groups, so the same drops), every position's log-softmax within 1e-3.
    (c) ``serve()``: ``requests`` prompts of ``prefix_len + block`` tokens
    (one 512-token routing group each), ``gen`` tokens each; reused blocks
    > 0.  (d) qwen3-moe-235b-a22b at full width, QWEN_LAYERS layers: two
    cache-less bfloat16 forwards over QWEN_SEQ tokens, finite logits, a
    flash launch per layer.  Every model is freed before the next arm."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import Transformer

    cfg = get_config(MOE_ARCH)
    rng = np.random.RandomState(SEED + 13)
    out = {}
    free_card()
    resident = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    cuda.reset_counts()

    # (a) prompt scoring
    t0 = time.perf_counter()
    model = Transformer(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, seq))).cuda()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = model.apply(toks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(o.logits).all())
    shape, aux = tuple(o.logits.shape), float(o.aux_loss)
    del o
    peak = torch.cuda.max_memory_allocated()
    flash_per_forward = cuda.LAUNCHES["flash_attention"] // len(times)
    out["forward_s"] = min(times)
    print(f"   (a) {cfg.name}: {n_params} parameters (init {init_s!r} s), "
          f"forward over {seq} tokens {times!r} s -> {seq / min(times)!r} "
          f"tokens/s [{card}]; logits {shape} finite={finite}, aux loss "
          f"{aux!r}; flash launches per forward {flash_per_forward}; peak "
          f"device memory {peak / 2**30!r} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30!r} "
          f"({resident / 2**30!r} GiB resident before the phase)",
          flush=True)
    check(finite and shape == (1, seq, cfg.vocab_size),
          "5g: the prompt-scoring logits are not finite or of the wrong "
          "shape")
    check(flash_per_forward == cfg.n_layers,
          f"5g: {flash_per_forward} flash launches per forward, not "
          f"{cfg.n_layers}")
    out["peak_bytes"] = peak
    out["forward_launches"] = flash_per_forward
    out["forward_profile"] = moe_profile(model, toks, card)
    del model
    free_card()

    # (b) the flash forward against the cached serving path, float32
    f32_before = cuda.LAUNCHES["flash_attention"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    m = cfg.moe
    nodrop = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    model = Transformer(nodrop, seed=SEED, device="cuda")
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (1, check_seq))).cuda()
    runs = [[], [], [], []]
    full = model.apply(toks, routes=runs[0]).logits[:, -1]
    cache = model.init_cache(1, check_seq + 4, dtype=torch.float32)
    half = m.group_size
    model.apply(toks[:, :half], cache=cache, cache_pos=0, routes=runs[1])
    model.apply(toks[:, half:-1], cache=cache, cache_pos=half,
                routes=runs[2])
    dec = model.apply(toks[:, -1:], cache=cache, cache_pos=check_seq - 1,
                      routes=runs[3]).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    out["serving_err"] = err
    first = first_flip(runs[1:], runs[:1], len(runs[0]), "(b)")
    print(f"   (b) flash forward vs cached prefill ({half} + "
          f"{check_seq - half - 1}) + decode, float32, S={check_seq}, "
          f"capacity factor {nodrop.moe.capacity_factor!r}: log-softmax max "
          f"err {err!r}; routes equal "
          f"{'everywhere' if first >= check_seq else f'before token {first}'}",
          flush=True)
    check(err < 1e-3, f"5g (b): the flash forward and the cached serving "
                      f"path differ by {err}")
    del model, cache, full, dec
    free_card()
    model = Transformer(dataclasses.replace(cfg, dtype="float32"), seed=SEED,
                        device="cuda")
    routes, pre_routes = [], []
    full = model.apply(toks, routes=routes).logits
    dropped = sum(int((~r.keep).sum()) for r in routes)
    cache = model.init_cache(1, check_seq, dtype=torch.float32)
    pre = model.apply(toks, cache=cache, cache_pos=0,
                      routes=pre_routes).logits
    first = min(check_seq, first_flip([pre_routes], [routes], len(routes),
                                      "(b')"))
    err = float((torch.log_softmax(full[:, :first], -1)
                 - torch.log_softmax(pre[:, :first], -1)).abs().max())
    out["prefill_err"] = err
    print(f"   (b') flash forward vs cached prefill, float32, S={check_seq}, "
          f"capacity factor {m.capacity_factor!r} ({dropped} (token, choice) "
          f"pairs dropped over {len(routes)} MoE layers): log-softmax max "
          f"err {err!r} over the first {first} of {check_seq} positions "
          f"(routes equal there)", flush=True)
    check(err < 1e-3, f"5g (b'): the flash forward and the cached prefill "
                      f"differ by {err}")
    f32_launches = cuda.LAUNCHES["flash_attention"] - f32_before
    del model, cache, full, pre, routes
    free_card()
    torch.backends.cuda.matmul.allow_tf32 = tf32

    # (c) the server
    res = serve(MOE_ARCH, requests=requests, prefix_len=prefix_len, gen=gen,
                smoke=False, seed=SEED, block=block, device="cuda")
    out["serve"] = res
    step_ms = (1e3 / res["decode_tokens_per_s"]
               if res["decode_tokens_per_s"] else float("nan"))
    print(f"   (c) serve {requests} requests x ({prefix_len} + {block} "
          f"prompt, {gen} generated) [{card}]: latency mean "
          f"{res['latency_mean_s']!r} s p99 {res['latency_p99_s']!r} s, "
          f"prefill {res['prefill_tokens_per_s']!r} tokens/s, decode "
          f"{res['decode_tokens_per_s']!r} tokens/s ({step_ms!r} ms a "
          f"step, batch 1; kernels a step: (a)'s decode profile), prefix "
          f"hit rate {res['prefix_hit_rate']!r}, reused blocks "
          f"{res['reused_blocks']}, index {res['index_stats']}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB",
          flush=True)
    check(res["reused_blocks"] > 0, "5g (c): serve reused no prefix block")
    free_card()

    # (d) qwen3-moe at full width, cut in depth
    qcfg = dataclasses.replace(get_config(QWEN_ARCH), n_layers=QWEN_LAYERS)
    model = Transformer(qcfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    qtoks = torch.from_numpy(rng.randint(0, qcfg.vocab_size,
                                         (1, QWEN_SEQ))).cuda()
    before = cuda.LAUNCHES["flash_attention"]
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = model.apply(qtoks)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    q_launches = (cuda.LAUNCHES["flash_attention"] - before) // len(walls)
    finite = bool(torch.isfinite(o.logits).all())
    print(f"   (d) {qcfg.name} x{QWEN_LAYERS} layers: {n_params} parameters, "
          f"forward over {QWEN_SEQ} tokens {walls!r} s (the first with "
          f"cuBLAS's plans) [{card}]; logits {tuple(o.logits.shape)} "
          f"finite={finite}, aux loss {float(o.aux_loss)!r}; flash launches "
          f"a forward {q_launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB", flush=True)
    check(finite, "5g (d): qwen3-moe logits are not finite")
    check(q_launches == QWEN_LAYERS, f"5g (d): {q_launches} flash launches "
                                     f"a forward, not {QWEN_LAYERS}")
    del model, o
    free_card()
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain} (float32 flash "
          f"launches of (b), (b'): {f32_launches})", flush=True)
    return launches, plain, out


# ------------- phase 5h: SSM, RG-LRU, cross-attention and prefix models --


def prefill_pieces(cfg, n: int) -> list[int]:
    """Lengths of the prefill calls that cover ``n`` tokens: one call,
    but an SSM model's prefill takes a multiple of its chunk or less than
    one chunk (``ssd_chunked``), so it runs as the chunks' multiple and
    then the rest."""
    if cfg.ssm is None or n <= cfg.ssm.chunk:
        return [n]
    whole = n // cfg.ssm.chunk * cfg.ssm.chunk
    return [whole] + ([n - whole] if n > whole else [])


def arch_forward(arch: str, card: str) -> dict:
    """5h (a) for one config: full width and depth (nemotron cut only if
    its float32 weights leave no room, printed), float32 weights from
    SEED, bfloat16 activations; a cache-less forward over ARCH_SEQ
    positions (nemotron: its max_seq_len) with the config's conditioning
    input, three times: wall s, positions/s, flash launches a forward,
    device busy by class (``class_trace``), peak device memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    cfg = get_config(arch)
    seq = min(ARCH_SEQ, cfg.max_seq_len)
    weights = cfg.param_count() * 4
    cut = ""
    if weights > 0.85 * PEAK_BYTES:
        layers = int(cfg.n_layers * 0.85 * PEAK_BYTES / weights)
        cfg = dataclasses.replace(cfg, n_layers=layers)
        cut = f", cut to {layers} of {get_config(arch).n_layers} layers"
    free_card()
    t0 = time.perf_counter()
    model = Transformer(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    kw = arch_conditions(cfg, 1, SEED + 17, dtype=torch.bfloat16,
                         device="cuda")
    n_prefix = kw["prefix_embeds"].shape[1] if "prefix_embeds" in kw else 0
    toks = torch.from_numpy(np.random.RandomState(SEED + 18).randint(
        0, cfg.vocab_size, (1, seq - n_prefix))).cuda()
    before = cuda.LAUNCHES["flash_attention"]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.apply(toks, **kw).logits
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = (cuda.LAUNCHES["flash_attention"] - before) // len(times)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    wall, by, n_kernels = class_trace(lambda: model.apply(toks, **kw))
    busy = sum(by.values())
    mem_note = (f", a {cfg.cross_attn_memory_len}-frame memory"
                if "memory" in kw else "")
    want = attention_layers(model) * (2 if "memory" in kw else 1)
    print(f"   (a) {cfg.name}: {n_params} parameters{cut} (init {init_s:.2f}"
          f" s), forward over {seq} positions ({n_prefix} prefix "
          f"embeddings{mem_note}) "
          f"{times!r} s -> {seq / min(times)!r} positions/s, "
          f"{(seq - n_prefix) / min(times)!r} tokens/s [{card}]; "
          f"logits {shape} finite={finite}; flash launches per forward "
          f"{launches}; traced {wall!r} ms, device busy {busy!r} ms (flash "
          f"{by['flash']!r}, matrix products {by['matmul']!r}, other "
          f"{by['other']!r}; {n_kernels} kernels), idle share "
          f"{1 - busy / wall!r}; peak device memory {peak / 2**30!r} GiB "
          f"({peak / 1e9!r} GB, limit {PEAK_BYTES / 1e9:.0f} GB)",
          flush=True)
    check(finite and shape == (1, seq - n_prefix, cfg.vocab_size),
          f"5h {arch}: logits not finite or of the wrong shape {shape}")
    check(launches == want, f"5h {arch}: {launches} flash launches a "
                            f"forward, not {want}")
    check(peak < PEAK_BYTES, f"5h {arch}: peak device memory {peak} B")
    del model, kw, toks
    free_card()
    return {"arch": arch, "layers": cfg.n_layers, "params": n_params,
            "positions": seq, "prefix": n_prefix, "forward_s": times,
            "positions_per_s": seq / min(times), "flash_launches": launches,
            "traced_ms": wall, "device_ms": by, "idle": 1 - busy / wall,
            "peak_bytes": peak}


def arch_consistency(arch: str) -> float:
    """5h (b): float32, TF32 off, full width and depth: the last
    position's log-softmax of the cache-less forward over ARCH_CHECK_SEQ
    tokens (with the config's conditioning input; llava: its 2880 prefix
    embeddings before them) against a cached prefill of all but the last
    token (``prefill_pieces``) and one decode step -> the max error."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = Transformer(cfg, seed=SEED, device="cuda")
    kw = arch_conditions(cfg, 1, SEED + 19, dtype=torch.float32,
                         device="cuda")
    mem = {k: v for k, v in kw.items() if k == "memory"}
    p = kw["prefix_embeds"].shape[1] if "prefix_embeds" in kw else 0
    n = ARCH_CHECK_SEQ
    toks = torch.from_numpy(np.random.RandomState(SEED + 20).randint(
        0, cfg.vocab_size, (1, n))).cuda()
    full = model.apply(toks, **kw).logits[:, -1]
    cache = model.init_cache(1, p + n + 4, dtype=torch.float32)
    a = 0
    for i, m in enumerate(prefill_pieces(cfg, n - 1)):
        model.apply(toks[:, a:a + m], cache=cache,
                    cache_pos=0 if i == 0 else p + a,
                    **(kw if i == 0 else mem))
        a += m
    dec = model.decode_step(cache, toks[:, -1:], p + n - 1,
                            **mem).logits[:, 0]
    err = float((torch.log_softmax(full, -1)
                 - torch.log_softmax(dec, -1)).abs().max())
    print(f"   (b) {cfg.name}: flash forward vs cached prefill "
          f"{prefill_pieces(cfg, n - 1)} + decode, float32, {n} tokens"
          f"{f' after {p} prefix embeddings' if p else ''}"
          f"{' with the memory' if mem else ''}: log-softmax max err "
          f"{err!r}", flush=True)
    check(err < 1e-3, f"5h (b) {arch}: the forward and the cached path "
                      f"differ by {err}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del model, cache, full, dec, kw
    free_card()
    return err


def arch_path(card: str, *, requests: int = 8, prefix_len: int = 496,
              block: int = 16, gen: int = 8) -> tuple[dict, dict, dict]:
    """Phase 5h: mamba2-1.3b (SSM), recurrentgemma-2b (RG-LRU + local
    attention), musicgen-large (cross-attention over a 256-frame memory),
    llava-next-mistral-7b (2880 prefix embeddings) and nemotron-4-15b at
    full width: (a) ``arch_forward``; (b) ``arch_consistency`` for the
    first four; (c) ``serve()`` of mamba2 and recurrentgemma, ``requests``
    prompts of ``prefix_len + block`` tokens (512: a multiple of mamba2's
    chunk), ``gen`` tokens each, through the OCF prefix index (kernels
    1-3).  Every model is freed before the next arm."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve
    free_card()
    torch.cuda.synchronize()
    cuda.reset_counts()
    out = {"forward": {}, "consistency": {}, "serve": {}}
    for arch in ARCH_PATH:
        out["forward"][arch] = arch_forward(arch, card)
    for arch in ARCH_PATH[:4]:
        out["consistency"][arch] = arch_consistency(arch)
    for arch in ARCH_SERVED:
        res = serve(arch, requests=requests, prefix_len=prefix_len, gen=gen,
                    smoke=False, seed=SEED, block=block, device="cuda")
        out["serve"][arch] = res
        print(f"   (c) {arch}: serve {requests} requests x ({prefix_len} + "
              f"{block} prompt, {gen} generated) [{card}]: latency mean "
              f"{res['latency_mean_s']!r} s p99 {res['latency_p99_s']!r} s, "
              f"prefill {res['prefill_tokens_per_s']!r} tokens/s, decode "
              f"{res['decode_tokens_per_s']!r} tokens/s, prefix hit rate "
              f"{res['prefix_hit_rate']!r}, reused blocks "
              f"{res['reused_blocks']}", flush=True)
        check(res["reused_blocks"] > 0, f"5h (c) {arch}: serve reused no "
                                        f"prefix block")
        free_card()
    torch.cuda.synchronize()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    print(f"   launches={launches} plain_calls={plain}", flush=True)
    missing = [k for k in ("flash_attention", "fingerprint_hash", "probe",
                           "insert_bulk") if not launches.get(k)]
    check(not missing, f"5h never launched {missing}")
    return launches, plain, out


# ------------------------- phase 5j: batcher, examples, dry-run on the host --

BATCHER_ARCHS = {"mla": ("deepseek-v2-lite-16b",),
                 "recurrent": ("mamba2-1.3b", "recurrentgemma-2b")}
BATCHER_REQUESTS = 4
BATCHER_SLOTS = 2
BATCHER_PROMPT = 512      # one routing group of 512; two mamba2 chunks
BATCHER_SHARED = 256      # the even requests' common prefix
BATCHER_GEN = 6
# example -> (the facts its output must show: regex, test on the match)
EXAMPLES = {
    "quickstart": ((r"false negatives: (\d+)", lambda v: v == 0),
                   (r"blind deletes blocked: (\d+)", lambda v: v == 1000),
                   (r"shrinks=(\d+)", lambda v: v > 0)),
    "adaptive_abuse_detection": (
        (r"round 0: false positives=\s*(\d+)", lambda v: v > 0),
        (r"replayed population: (\d+)", lambda v: v == 0)),
    "distributed_membership": (
        (r"present keys found: (\d+)/32768", lambda v: v == 32768),
        (r"(\d+) deferred", lambda v: v > 0),
        (r"pending=(\d+)", lambda v: v == 0)),
    "serve_with_prefix_cache": ((r"\((\d+) blocks reused\)",
                                 lambda v: v > 0),),
    "streaming_dedup": ((r"(\d+) duplicates dropped", lambda v: v > 0),
                        (r"after TTL: (\d+) generations retired",
                         lambda v: v > 0)),
}
# (arch, shape, mesh): gemma3-1b's train and prefill, the two cells the
# card machine's torch once refused, and one cell on the 2 x 16 x 16 mesh
DRYRUN_CELLS = (("gemma3-1b", "train_4k", "single"),
                ("gemma3-1b", "prefill_32k", "single"),
                ("recurrentgemma-2b", "train_4k", "single"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"),
                ("gemma3-1b", "train_4k", "multi"))
DRYRUN_TIMEOUT = 900


def batcher_path(card: str, archs) -> dict:
    """Phase 5j (a): ``ContinuousBatcher`` at full width over each arch's
    own cache kind (float32 weights from SEED, bfloat16 activations):
    BATCHER_REQUESTS prompts of BATCHER_PROMPT tokens (the even ones share
    BATCHER_SHARED) into BATCHER_SLOTS slots, BATCHER_GEN tokens each; the
    tokens equal ``generate``'s of each request alone, the prefix index
    reused blocks and launched its kernels, no plain version ran."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    from repro_torch.serving import ContinuousBatcher, Request, generate

    out = {}
    for arch in archs:
        free_card()
        cfg = get_config(arch)
        model = Transformer(cfg, seed=SEED, device="cuda")
        rng = np.random.RandomState(SEED + 23)
        shared = rng.randint(0, cfg.vocab_size, BATCHER_SHARED)
        prompts = [np.concatenate([shared, rng.randint(
            0, cfg.vocab_size, BATCHER_PROMPT - BATCHER_SHARED)]).astype(
            np.int32) if i % 2 == 0 else rng.randint(
            0, cfg.vocab_size, BATCHER_PROMPT).astype(np.int32)
            for i in range(BATCHER_REQUESTS)]
        cache_len = BATCHER_PROMPT + BATCHER_GEN
        torch.cuda.synchronize()
        cuda.reset_counts()
        b = ContinuousBatcher(model, slots=BATCHER_SLOTS,
                              cache_len=cache_len, block=16)
        reqs = [Request(rid=i, prompt=p, max_new=BATCHER_GEN)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        for r in reqs:
            check(b.submit(r), f"5j (a) {arch}: a request was refused")
        stats = b.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
        kind = sorted({type(c).__name__ for c in model.init_cache(
            1, 1, device="meta")["blocks"]})
        want = [generate(model, torch.from_numpy(r.prompt).cuda()[None, :],
                         BATCHER_GEN, cache_len=cache_len
                         ).tokens[0].tolist() for r in reqs]
        same = [r.out == w for r, w in zip(reqs, want)]
        print(f"   (a) {arch} [{card}]: caches {kind}, {BATCHER_REQUESTS} "
              f"requests x {BATCHER_PROMPT} tokens into {BATCHER_SLOTS} "
              f"slots, {BATCHER_GEN} generated: {wall!r} s, {stats}; "
              f"tokens {[r.out for r in reqs]}; equal to generate's: "
              f"{same}; launches {launches}", flush=True)
        check(all(same), f"5j (a) {arch}: the batcher's tokens differ from "
                         f"generate's: {[r.out for r in reqs]} vs {want}")
        check(stats.finished == BATCHER_REQUESTS
              and stats.prefix_blocks_reused > 0,
              f"5j (a) {arch}: {stats}")
        missing = [k for k in ("fingerprint_hash", "probe", "insert_bulk")
                   if not launches.get(k)]
        check(not missing, f"5j (a) {arch}: the prefix index never "
                           f"launched {missing}")
        check(sum(plain.values()) == 0,
              f"5j (a) {arch}: plain versions ran: {plain}")
        out[arch] = {"wall_s": wall, "stats": dataclasses.asdict(stats),
                     "launches": launches}
        del model, b, reqs
        free_card()
    return out


def run_examples(card: str) -> dict:
    """Phase 5j (b): the five filter examples as processes on the card, all
    started at once: each exits 0 (each asserts its own facts) and prints
    the facts of ``EXAMPLES``."""
    import re
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in EXAMPLES:
            procs[name] = subprocess.Popen(
                [sys.executable, str(root / "examples" / f"torch_{name}.py")],
                cwd=str(root), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=600)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for name, (stdout, stderr) in outs.items():
        rc = procs[name].returncode
        tail = " | ".join(stdout.strip().splitlines()[-3:])
        print(f"   (b) examples/torch_{name}.py on {card}: rc {rc}; {tail}",
              flush=True)
        check(rc == 0, f"5j (b) {name} exited {rc}: {stderr[-2000:]}")
        for pattern, ok in EXAMPLES[name]:
            m = re.search(pattern, stdout)
            check(m is not None and ok(int(m.group(1))),
                  f"5j (b) {name}: {pattern} not as expected in its output")
    print(f"   (b) five examples in {wall!r} s (concurrently)", flush=True)
    return {"wall_s": wall}


def start_dryrun(out_dir: Path) -> list:
    """Start phase 5j (c)'s dry-run cells, each a host process (no card:
    the fake process group and ``meta`` tensors), while the card runs the
    other phases -> [(cell, process, started)]."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    out = []
    for arch, shape, mesh in DRYRUN_CELLS:
        out.append(((arch, shape, mesh), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out",
             str(out_dir)], cwd=str(root), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), time.perf_counter()))
    return out


def stop_dryrun(procs: list) -> None:
    for _cell, p, _t in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def dryrun_path(card: str, procs: list, out_dir: Path, lm: dict,
                trained: dict) -> dict:
    """Phase 5j (c): read the dry-run processes (each prints an OK line and
    writes its record), and beside them the model-FLOPs share at the
    card's peak of 5c's forward and 5i's step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import SHAPES, canonical
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops_for

    out = {}
    try:
        for (arch, shape, mesh), p, t0 in procs:
            stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT)
            oks = [x for x in stdout.splitlines() if x.startswith("OK ")]
            print(f"   (c) dry-run {arch} {shape} {mesh} (host process, "
                  f"rc {p.returncode}, {time.perf_counter() - t0!r} s since "
                  f"it started): {oks}", flush=True)
            check(p.returncode == 0 and len(oks) == 1,
                  f"5j (c) dry-run {arch} {shape} {mesh}: {stdout[-1000:]} "
                  f"{stderr[-2000:]}")
            name = f"{canonical(arch)}__{shape}__{mesh}.json"
            rec = json.loads((out_dir / name).read_text())
            print(f"   (c) {arch} {shape} {mesh}: host seconds build "
                  f"{rec['t_build_s']!r}, trace {rec['t_trace_s']!r}; "
                  f"flops/device "
                  f"{rec['flops_per_dev']!r}, bytes/device "
                  f"{rec['bytes_per_dev']!r}, wire bytes/device "
                  f"{rec['wire_bytes_per_dev']!r}, collectives "
                  f"{rec['collectives']['count']}, bottleneck "
                  f"{rec['bottleneck']}, memory {rec['memory_stats']}",
                  flush=True)
            out[(arch, shape, mesh)] = rec
    finally:
        stop_dryrun(procs)
    cfg = get_config(LM_ARCH)
    n = cfg.active_param_count()
    for label, shape, tokens, secs in (
            ("5c forward", "prefill_32k", LM_SEQ, lm["forward_s"]),
            ("5i step", "train_4k", TRAIN_BATCH * TRAIN_SEQ,
             TRAIN_BATCH * TRAIN_SEQ / trained["tokens_per_s"])):
        seq, gbatch, _mode = SHAPES[shape]
        flops = model_flops_for(cfg, shape, n) * tokens / (seq * gbatch)
        share = flops / secs / PEAK_FLOPS
        print(f"   (c) {label} of {cfg.name}: {tokens} tokens in {secs!r} "
              f"s, model FLOPs {flops!r} -> {share!r} of {PEAK_FLOPS!r} "
              f"FLOP/s [{card}]", flush=True)
        out[label] = share
    return out


# --------------------------------------------------------- phase 6: times --


def time_ms(fn, reps: int, setup=None) -> float:
    """Mean time of ``fn`` on the device's timeline in ms over ``reps``
    calls: CUDA events around each call (``setup`` runs outside the timed
    span).  For a wrapper this includes the host time it takes to enqueue
    its launch."""
    import torch
    for _ in range(2):
        if setup:
            setup()
        fn()
    spans = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def kernel_device_ms(fn, reps: int, setup, symbol: str):
    """Mean device time in ms per launch of the kernels named ``symbol``
    that ``fn`` launches, from a ``torch.profiler`` (CUPTI) trace, averaged
    over the launches the trace holds with a device time (a trace now and
    then holds some launches without one, which would halve a mean over
    all); None when no window of up to six holds any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    for _attempt in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if setup:
                    setup()
                fn()
            torch.cuda.synchronize()
        names = (symbol,) if isinstance(symbol, str) else symbol
        spans = [getattr(ev, "device_time_total", 0.0) or 0.0
                 for ev in prof.events()
                 if any(n in ev.name for n in names)]
        spans = [us for us in spans if us > 0]
        if spans:
            return sum(spans) / len(spans) / 1e3
    return None


def least_ms(nbytes: float, ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take for some work: its bytes over
    the memory rate or its operations over the peak rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sectors(buckets) -> int:
    """Distinct 32-byte sectors that hold these 16-byte buckets."""
    import torch
    return int(torch.unique(buckets // (SECTOR // 16)).numel())


def table_work(before, after, hi, lo, valid, nb, *, lane_bytes: int,
               second):
    """(bytes, ops) one call on a table needs for this run's data: each
    key and mask once; the home bucket's sector of every valid lane; the
    alternate bucket's sector of the lanes ``second(fp, i1)`` says the
    home bucket cannot answer; and every sector the call changed, written
    once.  Distinct sectors are counted once: a sector that is one key's
    home and another's alternate is read once."""
    import torch
    from repro_torch.core import hashing
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    again = second(fp, i1) & valid
    changed = (before != after).any(dim=1).nonzero().flatten()
    reads = sectors(torch.cat([i1[valid], i2[again]]))
    nbytes = hi.numel() * lane_bytes + SECTOR * (reads + sectors(changed))
    ops = hi.numel() * HASH_OPS + 2 * before.shape[1] * (
        int(valid.sum()) + int(again.sum()))
    return nbytes, ops


def kernel_times(ocf, resident: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times at the main path's final
    state, for one 4096-key call each."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.delete import delete_bulk, delete_bulk_plain
    from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                 fingerprint_hash_plain)
    from repro_torch.kernels.insert import (insert_bulk, insert_bulk_plain,
                                            insert_bulk_tm)
    from repro_torch.kernels.probe import probe, probe_plain, probe_tm
    from repro_torch.kernels.rank import rank_among_earlier
    from repro_torch.kernels.telemetry import insert_plane

    dev = ocf.state.table.device
    nb = ocf.state.n_buckets
    base = ocf.state.table
    rng = np.random.RandomState(SEED + 2)

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    look_hi, look_lo = pair(np.concatenate([resident[: CHUNK // 2],
                                            random_keys(rng, CHUNK // 2)]))
    new_hi, new_lo = pair(random_keys(rng, CHUNK))
    del_hi, del_lo = pair(resident[CHUNK: 2 * CHUNK])
    valid = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    rounds = ocf.ops.evict_rounds
    iblock = min(kops.autotune_block("insert", table_bytes=base.numel() * 4,
                                     evict_rounds=rounds, n_keys=CHUNK), CHUNK)
    dblock = min(kops.autotune_block("delete", table_bytes=base.numel() * 4,
                                     n_keys=CHUNK), CHUNK)
    pblock = min(kops.autotune_block("probe", table_bytes=base.numel() * 4),
                 CHUNK)
    work = base.clone()

    def restore():
        work.copy_(base)

    # The lanes the home bucket cannot answer.  For insert and delete this
    # ranks each lane among all earlier lanes of the call against the
    # table it started from; the table only fills (insert) or empties
    # (delete) during a call, so this counts no lane that the kernel's
    # per-block schedule does not also send to its alternate bucket.
    def probe_second(fp, i1):
        return ~(hashing.to_u32(base[i1]) == fp[:, None]).any(dim=1)

    def insert_second(fp, i1):
        free = (base[i1] == 0).sum(dim=1)
        return rank_among_earlier(i1, valid) >= free

    def delete_second(fp, i1):
        copies = (hashing.to_u32(base[i1]) == fp[:, None]).sum(dim=1)
        return rank_among_earlier(i1, valid, fp) >= copies

    def after(kern):
        restore()
        kern()
        return work.clone()

    def probe_k():
        return probe(base, look_hi, look_lo, fp_bits=16, n_buckets=nb,
                     block=pblock)

    def insert_k():
        return insert_bulk(work, new_hi, new_lo, fp_bits=16, n_buckets=nb,
                           valid=valid, evict_rounds=rounds, block=iblock)

    def delete_k():
        return delete_bulk(work, del_hi, del_lo, fp_bits=16, n_buckets=nb,
                           valid=valid, block=dblock)

    def insert_tm_plain():
        ok, stats = insert_bulk_plain(work, new_hi, new_lo, valid, fp_bits=16,
                                      n_buckets=nb, evict_rounds=rounds,
                                      stash=None, block=iblock,
                                      want_stats=True)
        return work, ok, insert_plane(*stats, valid)

    n = CHUNK
    probe_bytes, probe_ops = table_work(base, base, look_hi, look_lo, valid,
                                        nb, lane_bytes=8 + 1,
                                        second=probe_second)
    insert_bytes, insert_ops = table_work(base, after(insert_k), new_hi,
                                          new_lo, valid, nb,
                                          lane_bytes=8 + 1 + 1,
                                          second=insert_second)
    rows = {
        "fingerprint_hash": (
            lambda: fingerprint_hash(new_hi, new_lo, fp_bits=16, n_buckets=nb),
            lambda: fingerprint_hash_plain(new_hi, new_lo, fp_bits=16,
                                           n_buckets=nb),
            None, (n * (8 + 12), n * HASH_OPS), "fingerprint_kernel"),
        "probe": (
            probe_k,
            lambda: probe_plain(base, look_hi, look_lo, fp_bits=16,
                                n_buckets=nb),
            None, (probe_bytes, probe_ops), "probe_kernel"),
        # The telemetry twins: the same work and a 16- or 40-byte plane.
        "probe_tm": (
            lambda: probe_tm(base, look_hi, look_lo, fp_bits=16,
                             n_buckets=nb, block=pblock),
            lambda: probe_stats_plane(probe_plain(
                base, look_hi, look_lo, fp_bits=16, n_buckets=nb,
                want_stats=True)),
            None, (probe_bytes + 16, probe_ops), "probe_kernel"),
        "insert_bulk_tm": (
            lambda: insert_bulk_tm(work, new_hi, new_lo, fp_bits=16,
                                   n_buckets=nb, valid=valid,
                                   evict_rounds=rounds, block=iblock),
            insert_tm_plain, restore, (insert_bytes + 40, insert_ops),
            "insert_kernel"),
        "insert_bulk": (
            insert_k,
            lambda: (work, insert_bulk_plain(work, new_hi, new_lo, valid,
                                             fp_bits=16, n_buckets=nb,
                                             evict_rounds=rounds, stash=None,
                                             block=iblock)),
            restore, (insert_bytes, insert_ops), "insert_kernel"),
        "delete_bulk": (
            delete_k,
            lambda: (work, delete_bulk_plain(work, del_hi, del_lo, valid,
                                             fp_bits=16, n_buckets=nb,
                                             block=dblock)),
            restore, table_work(base, after(delete_k), del_hi, del_lo, valid,
                                nb, lane_bytes=8 + 1 + 1,
                                second=delete_second),
            "delete_kernel"),
    }
    out = time_rows(rows)
    # Where a launch's time goes: one logical block (the fixed cost of a
    # launch and its staging, plus one block's rounds) and, for insert, the
    # two placement rounds alone (no eviction rounds).
    one = slice(0, iblock)
    parts = {
        "insert_bulk, one block": (lambda: insert_bulk(
            work, new_hi[one], new_lo[one], fp_bits=16, n_buckets=nb,
            valid=valid[one], evict_rounds=rounds, block=iblock),
            "insert_kernel"),
        "insert_bulk, no eviction rounds": (lambda: insert_bulk(
            work, new_hi, new_lo, fp_bits=16, n_buckets=nb, valid=valid,
            evict_rounds=0, block=iblock), "insert_kernel"),
        "delete_bulk, one block": (lambda: delete_bulk(
            work, del_hi[:dblock], del_lo[:dblock], fp_bits=16,
            n_buckets=nb, valid=valid[:dblock], block=dblock),
            "delete_kernel"),
    }
    for label, (fn, symbol) in parts.items():
        ms = kernel_device_ms(fn, 20, restore, symbol)
        print(f"   {label}: kernel {ms!r} ms (device)", flush=True)
    return out


def flat_tensors(out) -> list:
    """The tensors of a (nested) kernel or plain result, in order."""
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in flat_tensors(x)]
    return [out]


def hold_row(name: str, kern, plain, setup) -> None:
    """Run ``kern`` and ``plain`` once each from the same ``setup``,
    outside any timed span, and require every output (the tables they
    update in place among them) equal bit for bit (fatal)."""
    import torch
    if setup:
        setup()
    got = [t.clone() for t in flat_tensors(kern())]
    if setup:
        setup()
    want = [t.clone() for t in flat_tensors(plain())]
    check(len(got) == len(want), f"{name}: the kernel gives {len(got)} "
                                 f"outputs, the plain version {len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and a.dtype == b.dtype
              and torch.equal(a, b),
              f"{name} at full size: output {i} of the kernel differs from "
              f"the plain version's")
    print(f"   {name}: held at full size, {len(got)} outputs "
          f"({', '.join('x'.join(map(str, t.shape)) or '1' for t in got)}) "
          f"equal to the plain version's bit for bit", flush=True)


def probe_stats_plane(out):
    """(hit, (h1, h2, hs)) of a plain probe with stats -> (hit, the
    depth plane of every lane)."""
    from repro_torch.kernels.telemetry import probe_depth_counts
    hit, hs = out
    return hit, probe_depth_counts(*hs, hit | ~hit)


def time_rows(rows: dict, ops_per_s: float = SCALAR_OPS_PER_S, *,
              hold: bool = True) -> dict:
    """Device, wrapper, plain and bound times of each row
    ``name: (kernel call, plain call, setup, (bytes, ops), symbol)``, each
    held first against its plain version bit for bit (``hold_row``) unless
    ``hold`` is False (flash attention, which phase 2 holds within its
    tolerance at gemma3-1b's shapes).  The plain call returns what the
    kernel call does (the tables the calls update in place among them);
    ``symbol`` is a substring of the kernel's name in the profiler trace,
    or a tuple of them."""
    out = {}
    for name, (kern, plain, setup, (nbytes, ops), symbol) in rows.items():
        if hold:
            hold_row(name, kern, plain, setup)
        bound_ms, bound_by = least_ms(nbytes, ops, ops_per_s)
        # plain, kernel, kernel, plain: compare within one call, in turns.
        p1 = time_ms(plain, 3, setup)
        w1 = time_ms(kern, 20, setup)
        d1 = kernel_device_ms(kern, 20, setup, symbol)
        d2 = kernel_device_ms(kern, 20, setup, symbol)
        w2 = time_ms(kern, 20, setup)
        p2 = time_ms(plain, 3, setup)
        check(d1 is not None and d2 is not None,
              f"{name}: the profiler trace holds no device time for "
              f"{symbol}")
        out[name] = {"ms": (d1 + d2) / 2, "wrapper_ms": (w1 + w2) / 2,
                     "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                     "device_ms_windows": [d1, d2]}
        print(f"   {name}: kernel {d1!r} / {d2!r} ms (device), wrapper "
              f"{w1!r} / {w2!r} ms, plain {p1!r} / {p2!r} ms, bound "
              f"{bound_ms!r} ms ({nbytes} B, {ops} ops)", flush=True)
    return out


def sectors_of(index, per_sector: int) -> int:
    """Distinct 32-byte sectors holding rows ``index`` of a plane whose
    rows are ``32 / per_sector`` bytes."""
    import torch
    return int(torch.unique(index // per_sector).numel())


def adaptive_work(before, after, hi, lo, valid, nb, *, lane_bytes: int,
                  second, sel_rows: str, key_ops: int, slot_ops: int):
    """(bytes, ops) of one call on the four adaptive planes, for this run's
    data: keys and masks once; the home bucket's table sector of every
    valid lane and the alternate's for the lanes ``second(i1)`` says the
    home cannot answer; the selector-word sectors of those rows that the
    call must read (``sel_rows``: "none"; "all"; "matching", only the rows
    in which some slot holds one of the key's four family fingerprints,
    the least an exact lookup reads, since no other row can hit whatever
    its selectors); every changed sector of each of the four planes,
    written once.  Distinct sectors are counted once."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels.selector import fp_family
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    again = second(i1) & valid
    looked = torch.cat([i1[valid], i2[again]])
    bucket_row = SECTOR // (4 * before[0].shape[1])      # buckets / sector
    reads = sectors_of(looked, bucket_row)
    if sel_rows == "all":
        reads += sectors_of(looked, SECTOR // 4)
    elif sel_rows == "matching":
        fam = [hashing.to_i32(f) for f in fp_family(hi, lo, 16)]

        def matching(rows, lanes):
            row = before[0][rows[lanes]]
            hit = torch.zeros(row.shape[0], dtype=torch.bool,
                              device=row.device)
            for f in fam:
                hit |= (row == f[lanes][:, None]).any(dim=1)
            return rows[lanes][hit]
        reads += sectors_of(torch.cat([matching(i1, valid),
                                       matching(i2, again)]), SECTOR // 4)
    writes = 0
    for plane, old, new in zip(("table", "sels", "khi", "klo"), before,
                               after):
        changed = (old != new).any(dim=1).nonzero().flatten()
        writes += sectors_of(changed, SECTOR // 4 if plane == "sels"
                             else bucket_row)
    nbytes = hi.numel() * lane_bytes + SECTOR * (reads + writes)
    ops = hi.numel() * key_ops + slot_ops * before[0].shape[1] * (
        int(valid.sum()) + int(again.sum()))
    return nbytes, ops


def adaptive_kernel_times(m, remaining: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times of the adaptive kernels at
    the adaptive path's final state, for one 4096-key call each."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.delete import (delete_bulk_adaptive,
                                            delete_bulk_adaptive_plain)
    from repro_torch.kernels.fingerprint import (
        fingerprint_hash_family, fingerprint_hash_family_plain)
    from repro_torch.kernels.insert import (insert_bulk_adaptive,
                                            insert_bulk_adaptive_plain,
                                            insert_bulk_adaptive_tm)
    from repro_torch.kernels.probe import (probe_adaptive,
                                           probe_adaptive_plain,
                                           probe_adaptive_tm)
    from repro_torch.kernels.rank import rank_among_earlier
    from repro_torch.kernels.selector import (fp_family, sel_unpack,
                                              select_fp)
    from repro_torch.kernels.telemetry import insert_plane

    st = m.filt.state
    nb, dev = st.n_buckets, st.table.device
    base = [st.table, st.sels, st.khi, st.klo]
    stash = m.filt.stash
    work = [p.clone() for p in base]
    rng = np.random.RandomState(SEED + 5)

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    look_hi, look_lo = pair(np.concatenate([remaining[: CHUNK // 2],
                                            random_keys(rng, CHUNK // 2)]))
    new_hi, new_lo = pair(random_keys(rng, CHUNK))
    del_hi, del_lo = pair(remaining[CHUNK: 2 * CHUNK])
    valid = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    rounds = m.filt.ops.evict_rounds
    plane_bytes = kops._adaptive_plane_bytes(st.table)
    iblock = min(kops.autotune_block("insert", table_bytes=plane_bytes,
                                     evict_rounds=2 * rounds, n_keys=CHUNK),
                 CHUNK)
    dblock = min(kops.autotune_block("delete", table_bytes=plane_bytes,
                                     n_keys=CHUNK), CHUNK)
    pblock = min(kops.autotune_block("probe", table_bytes=plane_bytes),
                 CHUNK)

    def restore():
        for w, b in zip(work, base):
            w.copy_(b)

    def after(kern):
        restore()
        kern()
        return [w.clone() for w in work]

    def home_hits(hi, lo):
        """Per lane, the copies of its key the home bucket holds under the
        slots' selectors."""
        fam = fp_family(hi, lo, 16)
        i1 = hashing.index_hash(hi, lo, nb)
        exp = hashing.to_i32(select_fp(fam, sel_unpack(base[1][i1], 4)))
        return (base[0][i1] == exp).sum(dim=1), hashing.to_i32(fam[0])

    look_home, _ = home_hits(look_hi, look_lo)
    del_home, del_fp0 = home_hits(del_hi, del_lo)

    def probe_second(i1):
        return look_home == 0

    def insert_second(i1):
        return rank_among_earlier(i1, valid) >= (base[0][i1] == 0).sum(dim=1)

    def delete_second(i1):
        return rank_among_earlier(i1, valid, del_fp0) >= del_home

    # The path's lookups always pass its stash (128 slots, empty there).
    def probe_k(st=stash):
        return probe_adaptive(base[0], base[1], look_hi, look_lo, fp_bits=16,
                              n_buckets=nb, stash=st, block=pblock)

    def probe_work(sel_rows):
        nbytes, ops = adaptive_work(base, base, look_hi, look_lo, valid, nb,
                                    lane_bytes=8 + 1, second=probe_second,
                                    sel_rows=sel_rows, key_ops=FAMILY_OPS,
                                    slot_ops=3)
        return nbytes + stash.numel() * 4, ops

    def insert_k():
        return insert_bulk_adaptive(*work, new_hi, new_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid,
                                    evict_rounds=rounds, block=iblock)

    def delete_k():
        return delete_bulk_adaptive(*work, del_hi, del_lo, fp_bits=16,
                                    n_buckets=nb, valid=valid, block=dblock)

    def insert_tm_plain():
        ok, stats = insert_bulk_adaptive_plain(
            *work, new_hi, new_lo, valid, fp_bits=16, n_buckets=nb,
            evict_rounds=rounds, stash=None, block=iblock, want_stats=True)
        return (*work, ok, insert_plane(*stats, valid))

    n = CHUNK
    insert_bytes, insert_ops = adaptive_work(
        base, after(insert_k), new_hi, new_lo, valid, nb,
        lane_bytes=8 + 1 + 1, second=insert_second, sel_rows="none",
        key_ops=HASH_OPS, slot_ops=2)
    p_bytes, p_ops = probe_work("matching")
    rows = {
        "fingerprint_hash_family": (
            lambda: fingerprint_hash_family(new_hi, new_lo, fp_bits=16,
                                            n_buckets=nb),
            lambda: fingerprint_hash_family_plain(new_hi, new_lo,
                                                  fp_bits=16, n_buckets=nb),
            None, (n * (8 + 24), n * FAMILY_OPS), "family_kernel"),
        "probe_adaptive": (
            probe_k,
            lambda: probe_adaptive_plain(base[0], base[1], look_hi, look_lo,
                                         fp_bits=16, n_buckets=nb,
                                         stash=stash),
            None, (p_bytes, p_ops), "probe_adaptive_kernel"),
        # The telemetry twins: the same work and a 16- or 40-byte plane.
        "probe_adaptive_tm": (
            lambda: probe_adaptive_tm(base[0], base[1], look_hi, look_lo,
                                      fp_bits=16, n_buckets=nb, stash=stash,
                                      block=pblock),
            lambda: probe_stats_plane(probe_adaptive_plain(
                base[0], base[1], look_hi, look_lo, fp_bits=16,
                n_buckets=nb, stash=stash, want_stats=True)),
            None, (p_bytes + 16, p_ops), "probe_adaptive_kernel"),
        "insert_bulk_adaptive_tm": (
            lambda: insert_bulk_adaptive_tm(
                *work, new_hi, new_lo, fp_bits=16, n_buckets=nb,
                valid=valid, evict_rounds=rounds, block=iblock),
            insert_tm_plain, restore, (insert_bytes + 40, insert_ops),
            "insert_adaptive_kernel"),
        "insert_bulk_adaptive": (
            insert_k,
            lambda: (*work, insert_bulk_adaptive_plain(
                *work, new_hi, new_lo, valid, fp_bits=16, n_buckets=nb,
                evict_rounds=rounds, stash=None, block=iblock)),
            restore, (insert_bytes, insert_ops), "insert_adaptive_kernel"),
        "delete_bulk_adaptive": (
            delete_k,
            lambda: (*work, delete_bulk_adaptive_plain(
                *work, del_hi, del_lo, valid, fp_bits=16, n_buckets=nb,
                block=dblock)),
            restore, adaptive_work(base, after(delete_k), del_hi, del_lo,
                                   valid, nb, lane_bytes=8 + 1 + 1,
                                   second=delete_second, sel_rows="all",
                                   key_ops=FAMILY_OPS, slot_ops=3),
            "delete_adaptive_kernel"),
    }
    out = time_rows(rows)
    old_bytes, old_ops = probe_work("all")
    print(f"   probe_adaptive bound, a selector sector for every row looked "
          f"at (the earlier count): {least_ms(old_bytes, old_ops)[0]!r} ms "
          f"({old_bytes} B)", flush=True)
    ms = kernel_device_ms(lambda: probe_k(None), 20, None,
                          "probe_adaptive_kernel")
    print(f"   probe_adaptive, {CHUNK} keys without a stash: {ms!r} ms "
          f"(device)", flush=True)
    out["probe_adaptive"]["no_stash_ms"] = ms
    return out


def flushed_event_ms(fn, reps: int, flush) -> float | None:
    """Mean device ms of ``fn``'s launches by CUDA events around each, with
    ``flush`` (a write larger than the L2) before each.  A spin kernel
    enqueued first keeps the device behind the host, so no host time falls
    inside a span; None when the host took longer to enqueue the launches
    than the spin lasted."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0.record()
    torch.cuda._sleep(400_000_000)      # ~0.2 s at the H100's clocks
    s1.record()
    t0 = time.perf_counter()
    spans = []
    for _ in range(reps):
        flush()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        spans.append((a, b))
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= s0.elapsed_time(s1):
        print(f"   the host took {host_ms!r} ms to enqueue, longer than the "
              f"spin: the spans may hold host time", flush=True)
        return None
    return sum(a.elapsed_time(b) for a, b in spans) / reps


def probe_adaptive_path_times(m, remaining: np.ndarray,
                              benign: np.ndarray) -> dict:
    """probe_adaptive at the launch size of the adaptive path's lookups, on
    its final state with its stash: the 10M benign keys (the path's stash,
    empty there; then a copy with all 128 slots live) and the remaining
    members.  Each launch is first held against the plain version on the
    same inputs, bit for bit (fatal), outside the timed spans.  Device ms
    by CUDA events with L2 flushed before each launch (and by the profiler
    beside them), with the bound of each launch's data; a reading under
    its bound is a wrong timing, printed as such and not kept."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.probe import (probe_adaptive,
                                           probe_adaptive_plain,
                                           probe_adaptive_tm)
    from repro_torch.kernels.selector import fp_family, sel_unpack, select_fp
    from repro_torch.kernels.telemetry import probe_depth_counts

    st = m.filt.state
    nb, dev = st.n_buckets, st.table.device
    table, sels, stash = st.table, st.sels, m.filt.stash
    planted = stash.clone()
    rng = np.random.RandomState(SEED + 11)
    slots = stash.shape[1]
    planted[0] = torch.from_numpy(rng.randint(1, 1 << 16, slots)
                                  .astype(np.int32)).to(dev)
    planted[1] = torch.from_numpy(rng.randint(0, nb, slots)
                                  .astype(np.int32)).to(dev)
    flush_buf = torch.empty(1 << 25, dtype=torch.int32, device=dev)  # 128 MB

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    out = {}
    for label, keys, st_ in (("benign", benign, stash),
                             ("benign, 128 live stash entries", benign,
                              planted),
                             ("members", remaining, stash)):
        # Padded to the logical block, as the path's lookups pad them.
        block = min(kops.autotune_block(
            "probe", table_bytes=kops._adaptive_plane_bytes(table),
            stash_slots=slots), keys.size)
        hi, lo = (kops._pad_to(x, block)[0] for x in pair(keys))
        valid = torch.ones(hi.numel(), dtype=torch.bool, device=dev)
        i1 = hashing.index_hash(hi, lo, nb)
        exp = hashing.to_i32(select_fp(fp_family(hi, lo, 16),
                                       sel_unpack(sels[i1], 4)))
        home_miss = ~(table[i1] == exp).any(dim=1)
        del exp
        bounds = {}
        for sel_rows in ("all", "matching"):
            nbytes, ops = adaptive_work(
                [table], [table], hi, lo, valid, nb, lane_bytes=8 + 1,
                second=lambda _i1: home_miss, sel_rows=sel_rows,
                key_ops=FAMILY_OPS, slot_ops=3)
            bounds[sel_rows] = least_ms(nbytes + st_.numel() * 4, ops)

        def call(hi=hi, lo=lo, st_=st_, block=block):
            return probe_adaptive(table, sels, hi, lo, fp_bits=16,
                                  n_buckets=nb, stash=st_, block=block)
        def call_tm(hi=hi, lo=lo, st_=st_, block=block, n=keys.size):
            return probe_adaptive_tm(table, sels, hi, lo, fp_bits=16,
                                     n_buckets=nb, stash=st_, n_valid=n,
                                     block=block)
        got = call()
        want, hs = probe_adaptive_plain(table, sels, hi, lo, fp_bits=16,
                                        n_buckets=nb, stash=st_,
                                        want_stats=True)
        check(got.shape == want.shape and torch.equal(got, want),
              f"probe_adaptive at the path's size, {label}: kernel differs "
              f"from its plain version ({int((got != want).sum())} keys)")
        # The telemetry twin: the flag-off answers and the plain version's
        # depth plane of the path's keys (the padding uncounted).
        hit_tm, plane = call_tm()
        want_plane = probe_depth_counts(
            *hs, torch.arange(hi.numel(), device=dev) < keys.size)
        check(torch.equal(hit_tm, got) and torch.equal(plane, want_plane),
              f"probe_adaptive_tm at the path's size, {label}: differs from "
              f"the plain version with stats ({plane.tolist()} vs "
              f"{want_plane.tolist()})")
        n_hits = int(got.sum())
        del got, want, hs, hit_tm
        ms = flushed_event_ms(call, 20, flush_buf.zero_)
        tm_ms = flushed_event_ms(call_tm, 20, flush_buf.zero_)
        ms2 = flushed_event_ms(call, 20, flush_buf.zero_)
        prof = kernel_device_ms(call, 10, flush_buf.zero_,
                                "probe_adaptive_kernel")
        bound, by = bounds["matching"]
        print(f"   probe_adaptive at the path's size, {label}: "
              f"{hi.numel()} keys, {int(home_miss.sum())} home misses, "
              f"{n_hits} hits, same as the plain version, {ms!r} ms "
              f"(device, CUDA events, L2 flushed), profiler {prof!r} ms, "
              f"bound {bound!r} ms ({by}; with a selector "
              f"sector for every row looked at: {bounds['all'][0]!r} ms)",
              flush=True)
        print(f"   probe_adaptive_tm at the path's size, {label}: depth "
              f"plane {plane.tolist()} (home, alternate, stash, miss), same "
              f"as the plain version; {tm_ms!r} ms against the flag-off "
              f"kernel's {ms!r} / {ms2!r} ms (device, CUDA events, L2 "
              f"flushed; the twin's span holds its plane's zeroing)",
              flush=True)
        if ms is not None and ms < bound:
            print(f"   probe_adaptive {label}: {ms!r} ms is under its bound "
                  f"{bound!r} ms: the timing is wrong, not kept", flush=True)
            ms = None
        out[label] = {"keys": hi.numel(), "ms": ms, "bound_ms": bound,
                      "profiler_ms": prof, "tm_ms": tm_ms, "off_ms_2": ms2}
        del hi, lo, valid, i1, home_miss
    return out


def probe_work(table, stash, hi, lo, nb) -> tuple[int, int]:
    """(bytes, ops) one probe launch needs for this run's data, counted as
    ``table_work`` counts the 4096-key row (keys in, answers out, the home
    sector of every key, the alternate sector where the home bucket cannot
    answer), plus the stash's live entries read once."""
    import torch
    from repro_torch.core import hashing
    valid = torch.ones(hi.shape[0], dtype=torch.bool, device=hi.device)

    def second(fp, i1):
        return ~(hashing.to_u32(table[i1]) == fp[:, None]).any(dim=1)
    nbytes, ops = table_work(table, table, hi, lo, valid, nb,
                             lane_bytes=8 + 1, second=second)
    live = 0 if stash is None else int((stash[0] != 0).sum())
    return nbytes + 8 * live, ops


def path_row(label: str, call, symbol: str, work, floor: float,
             flush) -> dict:
    """Time one launch held before: device ms by the profiler (as the path
    runs it, the table warm in L2) and by CUDA events with ``flush``
    emptying the L2 before each launch; its bound, x bound and x the
    launch floor."""
    bound, by = least_ms(*work)
    warm = kernel_device_ms(call, 10, None, symbol)
    cold = flushed_event_ms(call, 10, flush)
    check(warm is not None, f"{label}: no device time for {symbol}")
    xb = None if cold is None else cold / bound
    print(f"   {label}: {warm!r} ms (device, profiler), {cold!r} ms "
          f"(device, CUDA events, L2 flushed); bound {bound!r} ms ({by}, "
          f"{work[0]} B); x bound {warm / bound!r}, flushed {xb!r}; "
          f"{warm / floor!r} x the launch floor", flush=True)
    return {"ms": warm, "flushed_ms": cold, "bound_ms": bound}


def probe_path_times(node: dict, floor: float) -> dict:
    """probe, probe_tm and fingerprint_hash at the launch sizes of their
    serving paths (``PROBE_PATH_SIZES``, ``FINGERPRINT_PATH_SIZES``), on
    phase 5e's node table as the ``uniform`` arm leaves it (2^20 buckets of
    4, fp_bits 16), half the keys held there and half absent: probe without
    a stash, with the arm's 128-slot stash, and with that stash's every
    slot live (half of them the fingerprint of an absent key of the call
    at one of its buckets, half random), so that the walk runs; probe_tm
    with the same three.  Each launch is first held against its plain
    version bit for bit (fatal), then timed by ``path_row``."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels.fingerprint import (fingerprint_hash,
                                                 fingerprint_hash_plain)
    from repro_torch.kernels.probe import probe, probe_plain, probe_tm
    from repro_torch.kernels.telemetry import probe_depth_counts

    table, nb, stash = node["table"], node["n_buckets"], node["stash"]
    dev = table.device
    rng = np.random.RandomState(SEED + 23)
    top = max(PROBE_PATH_SIZES)
    check(node["resident"].size >= top // 2,
          f"the node holds {node['resident'].size} keys, fewer than "
          f"{top // 2}")
    resident = node["resident"][rng.permutation(node["resident"].size)]
    absent = random_keys(rng, top)
    slots = stash.shape[1]
    a_hi, a_lo = hashing.key_to_u32_pair_np(absent[: slots // 2])
    a_fp = hashing.fingerprint_np(a_hi, a_lo, 16)
    a_i1 = hashing.index_hash_np(a_hi, a_lo, nb)
    planted = np.stack([rng.randint(1, 1 << 16, slots),
                        rng.randint(0, nb, slots)]).astype(np.uint32)
    planted[0, : slots // 2] = a_fp
    planted[1, : slots // 2] = a_i1
    planted = torch.from_numpy(planted.view(np.int32)).to(dev)
    # The L2 is emptied before each flushed launch by a 128 MB read, which
    # leaves no dirty line for the launch to write back (a write would).
    flush_buf = torch.ones(1 << 25, dtype=torch.int32, device=dev)
    sink = torch.empty((), dtype=torch.int64, device=dev)

    def flush():
        torch.sum(flush_buf, 0, dtype=torch.int64, out=sink)
    print(f"   node: {nb} buckets of {table.shape[1]}, "
          f"{node['resident'].size} keys held, the arm's stash "
          f"{int((stash[0] != 0).sum())} of {slots} slots live", flush=True)

    def pair(keys):
        hi, lo = hashing.key_to_u32_pair_np(keys)
        return (torch.from_numpy(hi.view(np.int32)).to(dev),
                torch.from_numpy(lo.view(np.int32)).to(dev))

    out = {}
    for n in PROBE_PATH_SIZES:
        hi, lo = pair(np.concatenate([resident[: n // 2],
                                      absent[: n - n // 2]]))
        block = min(n, 1024)
        for label, st in (("no stash", None), ("the arm's stash", stash),
                          ("every stash slot live", planted)):
            def call(hi=hi, lo=lo, st=st, block=block):
                return probe(table, hi, lo, fp_bits=16, n_buckets=nb,
                             stash=st, block=block)
            got = call()
            want, hs = probe_plain(table, hi, lo, fp_bits=16, n_buckets=nb,
                                   stash=st, want_stats=True)
            check(torch.equal(got, want),
                  f"probe at {n} keys, {label}: kernel differs from its "
                  f"plain version ({int((got != want).sum())} keys)")
            tag = (f"probe at the path's size, {n} keys, {label} "
                   f"({int(got.sum())} hits, {int(hs[2].sum())} from the "
                   f"stash, same as the plain version)")
            work = probe_work(table, st, hi, lo, nb)
            out[("probe", n, label)] = path_row(tag, call, "probe_kernel",
                                                work, floor, flush)

            def call_tm(hi=hi, lo=lo, st=st, block=block):
                return probe_tm(table, hi, lo, fp_bits=16, n_buckets=nb,
                                stash=st, block=block)
            hit_tm, plane = call_tm()
            want_plane = probe_depth_counts(*hs, hs[0] | ~hs[0])
            check(torch.equal(hit_tm, want)
                  and torch.equal(plane, want_plane),
                  f"probe_tm at {n} keys, {label}: differs from the plain "
                  f"version with stats ({plane.tolist()} vs "
                  f"{want_plane.tolist()})")
            out[("probe_tm", n, label)] = path_row(
                f"probe_tm at the path's size, {n} keys, {label} (depth "
                f"plane {plane.tolist()}, same as the plain version; the "
                f"span holds its plane's zeroing)", call_tm, "probe_kernel",
                (work[0] + 16, work[1]), floor, flush)
            del got, want, hs, hit_tm
    for n in FINGERPRINT_PATH_SIZES:
        hi, lo = pair(absent[:n])

        def call(hi=hi, lo=lo, n=n):
            return fingerprint_hash(hi, lo, fp_bits=16, n_buckets=nb,
                                    block=min(n, 1024))
        got = call()
        want = fingerprint_hash_plain(hi, lo, fp_bits=16, n_buckets=nb)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"fingerprint_hash at {n} keys: kernel differs from its "
              f"plain version")
        out[("fingerprint_hash", n, "")] = path_row(
            f"fingerprint_hash at the path's size, {n} keys (same as the "
            f"plain version)", call, "fingerprint", (n * (8 + 12),
                                                      n * HASH_OPS),
            floor, flush)
    return out


def streaming_kernel_times(snap, present: np.ndarray) -> dict:
    """Kernel, wrapper, plain and bound times of probe_multi on the
    streaming path's final ring (a copy of its pool with the live slots,
    before the TTL step), for one 4096-key call half present, half
    absent."""
    import torch
    from repro_torch.core import hashing
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.probe import probe_multi, probe_multi_plain

    tables, stashes, gens, nb = snap
    dev = tables.device
    b = tables.shape[2]
    slots = stashes.shape[2]
    rng = np.random.RandomState(SEED + 9)
    keys = np.concatenate([present[rng.randint(0, present.size, CHUNK // 2)],
                           random_keys(rng, CHUNK // 2)])
    hi, lo = (torch.from_numpy(x.view(np.int32)).to(dev)
              for x in hashing.key_to_u32_pair_np(keys))
    pblock = min(kops.autotune_block("probe", table_bytes=tables[0].numel()
                                     * 4, stash_slots=slots), CHUNK)

    # Bytes and operations this call's data needs: keys (8 B) and hits
    # (1 B) once; per live generation, in the kernel's (slot) order, the
    # home sector of every lane not yet answered and the alternate sector
    # only where the home bucket misses (distinct sectors once); every
    # live stash byte once, scanned by the lanes no table answered.
    fp = hashing.fingerprint(hi, lo, 16)
    i1 = hashing.index_hash(hi, lo, nb)
    i2 = hashing.alt_index(i1, fp, nb)
    pending = torch.ones(CHUNK, dtype=torch.bool, device=dev)
    reads, compares = 0, 0
    for g in sorted(gens):
        home = (hashing.to_u32(tables[g][i1]) == fp[:, None]).any(dim=1)
        alt = (hashing.to_u32(tables[g][i2]) == fp[:, None]).any(dim=1)
        again = pending & ~home
        reads += sectors(i1[pending]) + sectors(i2[again])
        compares += 2 * b * (int(pending.sum()) + int(again.sum()))
        pending &= ~(home | alt)
    k = len(gens)
    entries = sum(int((stashes[g][0] != 0).sum()) for g in gens)
    print(f"   probe_multi timed call: K={k} live generations, {entries} "
          f"live stash entries of {k * slots} slots, {int(pending.sum())} "
          f"of {CHUNK} keys no table answers", flush=True)
    nbytes = CHUNK * (8 + 1) + SECTOR * reads + k * 2 * slots * 4
    ops = CHUNK * HASH_OPS + compares + 3 * k * slots * int(pending.sum())
    rows = {"probe_multi": (
        lambda: probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                            stashes=stashes, gens=gens, block=pblock),
        lambda: probe_multi_plain(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                  stashes=stashes, gens=gens),
        None, (nbytes, ops), "probe_multi_kernel")}
    out = time_rows(rows)
    # Where a launch's time goes: the same keys without the stash scan,
    # and over the newest generation alone.
    for label, sts, gs in (("K=%d, no stashes" % k, None, gens),
                           ("K=1, stash", stashes, gens[-1:]),
                           ("K=1, no stash", None, gens[-1:])):
        ms = kernel_device_ms(
            lambda: probe_multi(tables, hi, lo, fp_bits=16, n_buckets=nb,
                                stashes=sts, gens=gs, block=pblock),
            20, None, "probe_multi_kernel")
        print(f"   probe_multi {label}: {ms!r} ms (device)", flush=True)
    return out


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave live, queries right-aligned."""
    qpos = np.arange(skv - sq, skv, dtype=np.int64)
    hi = np.minimum(qpos + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_kernel_times() -> dict:
    """Kernel, wrapper, plain, bound and library times of flash_attention
    at gemma3-1b's prompt-scoring shapes (bfloat16, B=1, Hq=4, Hkv=1,
    S=8192, D=256): a global layer (causal) and a local one (window 512).
    The bound is the larger of q, k, v and o moved once over the memory
    rate and 4 * Hq * D operations per live (query, key) pair over the
    bfloat16 tensor-core rate.  The library's yardstick is one
    ``scaled_dot_product_attention`` call on the same inputs (GQA, causal;
    the window as a boolean mask), timed here and used nowhere in the
    port.  The float32 kernel is timed too, at phase 5c (b)'s shape
    (S=1024), with its operations over the float32 CUDA-core rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cfg_window = 512
    b, hq, hkv, s, d = 1, 4, 1, LM_SEQ, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen)
               .to(torch.bfloat16) for shape in ((b, hq, s, d),
                                                 (b, hkv, s, d),
                                                 (b, hkv, s, d)))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - cfg_window)
    out = {}
    for label, window in (("global", None), ("local", cfg_window)):
        ops = 4 * hq * d * live_pairs(s, s, True, window) * b
        rows = {f"flash_attention ({label})": (
            lambda w=window: flash_attention(q, k, v, window=w),
            lambda w=window: flash_attention_plain(q, k, v, window=w),
            None, (nbytes, ops), "flash_wgmma_kernel")}
        row = time_rows(rows, TENSOR_OPS_PER_S, hold=False)[
            f"flash_attention ({label})"]
        mask = (dict(is_causal=True) if window is None
                else dict(attn_mask=band))

        def lib(mask=mask):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)
        row["library_ms"] = (time_ms(lib, 10) + time_ms(lib, 10)) / 2
        diff = float((lib().float() - flash_attention(
            q, k, v, window=window).float()).abs().max())
        how = ("causal" if window is None else
               "a dense boolean band mask: SDPA has no windowed fast path")
        print(f"   flash_attention ({label}): scaled_dot_product_attention "
              f"{row['library_ms']!r} ms ({how}), max |difference| "
              f"{diff!r}; {ops} operations", flush=True)
        out[label] = row
    # flash_f32_kernel at phase 5c (b)'s shape: float32, S = 1024, on the
    # CUDA cores (bound: the float32 rate outside the tensor cores).
    s32 = 1024
    q, k, v = (x[:, :, :s32].float().contiguous() for x in (q, k, v))
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    for label, window in (("global", None), ("local", cfg_window)):
        ops = 4 * hq * d * live_pairs(s32, s32, True, window) * b
        name = f"flash_attention float32 S={s32} ({label})"
        out[name] = time_rows({name: (
            lambda w=window: flash_attention(q, k, v, window=w),
            lambda w=window: flash_attention_plain(q, k, v, window=w),
            None, (nbytes, ops), "flash_f32_kernel")}, hold=False)[name]
    return out


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (``torch._fused_sdp_choice``; GQA where q has more heads than k), or
    "none" where it names none."""
    import torch
    try:
        from torch.nn.attention import SDPBackend
        if q.shape[1] != k.shape[1]:
            kw = dict(kw, enable_gqa=True)
        return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    except Exception as exc:                     # noqa: BLE001
        return f"none ({type(exc).__name__}: {exc})"


def mla_flash_times() -> dict:
    """flash_attention at deepseek-v2-lite's cache-less MLA shape
    (bfloat16, B=1, Hq=Hkv=16, S=MOE_SEQ; q and k of 192, v of 128, which
    ``ops.attention`` zero-pads to 256): the kernel's device time, the
    wrapper (``ops.attention``: padding, launch, cut), the plain version
    on the padded heads, and the bound: 2 * (Dk + Dv) * Hq operations per
    live (query, key) pair at the unpadded Dk = 192 and Dv = 128 over the
    bfloat16 tensor-core rate, or q, k, v and o moved once over the memory
    rate, the larger.  The library's yardstick: one
    ``scaled_dot_product_attention`` call on the unpadded q, k, v (causal,
    the same scale), with the backend it picks; null where none runs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    b, h, s, dk, dv = 1, 16, MOE_SEQ, 192, 128
    scale = dk ** -0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen)
               .to(torch.bfloat16) for shape in ((b, h, s, dk), (b, h, s, dk),
                                                 (b, h, s, dv)))
    padded = [F.pad(t, (0, 256 - t.shape[-1])) for t in (q, k, v)]
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + b * h * s * dv)
    n_ops = 2 * (dk + dv) * h * live_pairs(s, s, True, None) * b
    name = "flash_attention (MLA, padded to 256)"
    row = time_rows({name: (
        lambda: ops.attention(q, k, v, scale=scale),
        lambda: flash_attention_plain(*padded, scale=scale)[..., :dv],
        None, (nbytes, n_ops), "flash_wgmma_kernel")}, TENSOR_OPS_PER_S,
        hold=False)[name]
    backend = sdpa_backend(q, k, v, is_causal=True, scale=scale)

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)
    try:
        row["library_ms"] = (time_ms(lib, 5) + time_ms(lib, 5)) / 2
        diff = float((lib().float() - ops.attention(
            q, k, v, scale=scale).float()).abs().max())
    except RuntimeError as exc:
        row["library_ms"], diff = None, None
        backend = f"none ({exc})"
    row.update(library_backend=backend, x_bound=row["ms"] / row["bound_ms"],
               shape=[b, h, s, dk, dv])
    print(f"   {name}: x bound {row['x_bound']!r}; "
          f"scaled_dot_product_attention on the unpadded heads "
          f"{row['library_ms']!r} ms (backend {backend}), max |difference| "
          f"{diff!r}; {n_ops} operations", flush=True)
    del q, k, v, padded
    return row


def arch_flash_times() -> dict:
    """flash_attention at phase 5h's shapes (FlashKernelBench.PATH_CASES,
    bfloat16): device time, wrapper, plain version and bound (4 * Hq * D
    operations per live (query, key) pair over the bfloat16 tensor-core
    rate, or q, k, v and o moved once, the larger), beside one
    ``scaled_dot_product_attention`` call on the same inputs (GQA; the
    window as a dense boolean band mask), timed here and used nowhere in
    the port."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    labels = ("recurrentgemma local", "musicgen self", "musicgen cross",
              "llava", "nemotron")
    out = {}
    for label, case in zip(labels, FlashKernelBench.PATH_CASES):
        b, hq, hkv, sq, skv, d, causal, window, _cap = case
        q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                   .to(torch.bfloat16) for shape in ((b, hq, sq, d),
                                                     (b, hkv, skv, d),
                                                     (b, hkv, skv, d)))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        n_ops = 4 * hq * d * live_pairs(sq, skv, causal, window) * b
        kw = dict(causal=causal, window=window)
        name = f"flash_attention ({label})"
        row = time_rows({name: (
            lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_plain(q, k, v, **kw),
            None, (nbytes, n_ops), "flash_wgmma_kernel")}, TENSOR_OPS_PER_S,
            hold=False)[name]
        if window is not None:
            pos = torch.arange(skv, device="cuda")
            qpos = pos[skv - sq:, None]
            mask = dict(attn_mask=(pos[None, :] <= qpos)
                        & (pos[None, :] > qpos - window))
        else:
            mask = dict(is_causal=causal)

        def lib(mask=mask):
            return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **mask)
        row["library_ms"] = (time_ms(lib, 10) + time_ms(lib, 10)) / 2
        diff = float((lib().float() - flash_attention(
            q, k, v, **kw).float()).abs().max())
        row.update(shape=list(case[:8]), x_bound=row["ms"] / row["bound_ms"],
                   library_backend=sdpa_backend(q, k, v, **mask))
        d1, d2 = row["device_ms_windows"]
        if abs(d1 - d2) > 0.1 * max(d1, d2):
            # the profiler now and then loses launches of a window; the
            # CUDA-event time of the wrapper is the cross-check
            print(f"   {name}: the two profiler windows disagree ({d1!r} / "
                  f"{d2!r} ms); CUDA events read {row['wrapper_ms']!r} ms "
                  f"a call", flush=True)
        print(f"   {name} {case[:8]}: x bound {row['x_bound']!r}; "
              f"scaled_dot_product_attention {row['library_ms']!r} ms "
              f"(backend {row['library_backend']}), max |difference| "
              f"{diff!r}; {n_ops} operations", flush=True)
        out[label] = row
        del q, k, v, mask
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel of an ``nvcc -Xptxas -v`` log: its name
    (``name_kernel<D>``, read from the mangled symbol), registers, static
    shared memory and spills.  The flash kernels' tiles are dynamic shared
    memory, sized at launch (``csrc/flash_attention.cu``)."""
    import re
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            # Itanium mangling: _Z, N for a nested name, then each
            # component as its length and identifier (the anonymous
            # namespace's carries digits of its own); the kernel is the
            # last, and a template argument <D> follows as ILi<D>E.
            z = re.match(r"_ZN?", name)
            pos, ident = (z.end() if z else len(name)), None
            while (k := re.match(r"\d+", name[pos:])):
                pos += len(k.group()) + int(k.group())
                ident = name[pos - int(k.group()):pos]
            if ident:
                t = re.match(r"I((?:L[a-z]+\d+E)+)E", name[pos:])
                args = re.findall(r"L[a-z]+(\d+)E", t.group(1)) if t else []
                name = ident + (f"<{','.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


# library -> {wgmma kernel: (C function giving a CTA's dynamic shared
# memory at head dim d, its leading arguments, the head dims it is built
# for)}
WGMMA_KERNELS = {
    "flash_attention": {"flash_wgmma_kernel": (
        "lm_flash_wgmma_smem_bytes", (), (16, 32, 64, 128, 256))},
    "flash_attention_bwd_pre": {
        "flash_bwd_dkdv_wgmma_kernel": ("lm_flash_bwd_wgmma_smem_bytes",
                                        (0,), (64, 128, 256)),
        "flash_bwd_dq_wgmma_kernel": ("lm_flash_bwd_wgmma_smem_bytes",
                                      (1,), (64, 128, 256))},
}


def wgmma_report(name: str, summary: list[str]) -> list[str]:
    """The lines of ``ptxas_summary`` of the wgmma kernels of library
    ``name`` (``WGMMA_KERNELS``), each with the CTA's dynamic shared memory
    from the library; raises on any spill or a head dim not built."""
    import ctypes
    import re
    from repro_torch.kernels import cuda
    lib = ctypes.CDLL(str(cuda._lib_path(name)))
    out = []
    for kernel, (symbol, lead, dims) in WGMMA_KERNELS[name].items():
        smem = getattr(lib, symbol)
        smem.argtypes = [ctypes.c_int] * (len(lead) + 1)
        smem.restype = ctypes.c_int
        seen = []
        for line in summary:
            m = re.match(rf"{kernel}<(\d+)>", line)
            if not m:
                continue
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            check(spills and not any(spills),
                  f"ptxas spills in {kernel}: {line}")
            seen.append(int(m.group(1)))
            out.append(f"{line}; {smem(*lead, seen[-1])} bytes of dynamic "
                       f"shared memory a CTA")
        check(sorted(seen) == list(dims), f"ptxas reported {kernel} at "
                                          f"head dims {seen}, not {dims}")
    return out


# ------------------------------------------------------------------ main --


# ---------------------------------- phases 2, 3, 5f: the sharded filter --

# One sharded node set at node size (phase 5f): benchmarks/elastic_bench.py's
# settings (fp_bits 16, a 128-slot stash a shard, route "pair", capacity
# factor 4.0) with n_buckets scaled from 512 to 2^20 a shard (the 16 MB
# table of phases 5d and 5e), filled through the pump to elastic_bench's
# load, 3072 of 4096 slots.
SHARDED = dict(n_shards=2, n_buckets=1 << 20, bucket_size=4, stash_slots=128,
               fp_bits=16, route="pair", capacity_factor=4.0)
SHARDED_KEYS = 6 * (1 << 20)          # 6,291,456: load 0.75 of 2 x 2^22
# elastic_bench's concurrent stream (256 keys beside 3072), scaled the same:
# parked by the pump while the split runs, replayed after the cutover.
SHARDED_CONCURRENT = 1 << 19
SHARDED_WAVE = 1 << 18                # a pump submit
SHARDED_BATCH = 1 << 20               # a routed lookup or delete call
SCAN_KERNELS = ("scan_insert", "scan_delete")


SCAN_WINDOWS = (1, 32)         # beside scan.MAX_WINDOW


def scan_shares(stats, lanes: int) -> str:
    """The insert kernel's schedule counts as shares of its walked lanes."""
    from repro_torch.kernels.scan import SCHEDULE_FIELDS
    return ", ".join(f"{k} {int(v) / max(lanes, 1):.4f}"
                     for k, v in zip(SCHEDULE_FIELDS, stats.tolist()))


def scan_vs_plain() -> dict:
    """Phase 2: ``scan_insert`` and ``scan_delete`` against their plain
    versions on the card, bit for bit, on SCAN_CASES (key mode on a
    2^12-bucket table driven to load 0.97 by 2^14 keys, pair mode into a
    16-slot stash that fills, deletes of 2^14 keys with duplicates, a stack
    of shards in one launch, crowded rows, windows whose chains cross their
    edges, spills inside a window, self-pairs, deletes of one fingerprint
    across one bucket pair), each insert case at windows of 1, 32 and
    ``MAX_WINDOW`` lanes -> max abs error by kernel."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.scan import (MAX_WINDOW, delete_groups,
                                          scan_delete, scan_delete_plain,
                                          scan_insert, scan_insert_plain)
    from repro_torch.kernels.staging_cases import SCAN_CASES, scan_inputs

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32).copy()).cuda()

    err = {}
    for label in SCAN_CASES:
        tables, stashes, a, b, valid, kw = scan_inputs(label)
        mode = kw.pop("mode")
        name = "scan_delete" if mode == "delete" else "scan_insert"
        va = torch.from_numpy(valid).cuda()
        tt, st = dev(tables), dev(stashes)
        if mode == "delete":
            args = dict(n_buckets=kw["n_buckets"], fp_bits=kw["fp_bits"])
            want = [tt, scan_delete_plain(tt, dev(a), dev(b), va, **args)]
            keys = delete_groups(dev(a), dev(b), va, **args)[4]
            runs = {f"{int((keys[1:] != keys[:-1]).sum()) + 1} conflict "
                    f"groups": lambda tt, st: scan_delete(
                        tt, dev(a), dev(b), valid=va, **args)}
        else:
            args = dict(n_buckets=kw["n_buckets"], mode=mode,
                        fp_bits=kw["fp_bits"], max_disp=kw["max_disp"])
            want = [x for x in (tt, st, scan_insert_plain(
                tt, dev(a), dev(b), va, stashes=st, **args)) if x is not None]
            stats = torch.zeros(4, dtype=torch.int64, device="cuda")

            def run(tt, st, w):
                stats.zero_()
                return scan_insert(tt, dev(a), dev(b), valid=va, stashes=st,
                                   window=w, stats=stats, **args)
            runs = {f"window {w}": (lambda tt, st, w=w: run(tt, st, w))
                    for w in (*SCAN_WINDOWS, MAX_WINDOW)}
        for how, fn in runs.items():
            tt, st = dev(tables), dev(stashes)
            cuda.reset_counts()
            ok = fn(tt, st)
            check(cuda.LAUNCHES[name] == 1 and not cuda.PLAIN_CALLS,
                  f"{name} case {label}: not one launch of the kernel")
            got = [x for x in (tt, st, ok) if x is not None]
            for x, y in zip(got, want):
                check(torch.equal(x, y), f"{name} case {label} ({how}): the "
                                         f"kernel differs from its plain "
                                         f"version")
            fails = int((va & ~ok).sum())
            spilled = ("" if stashes is None else
                       f", stash {int((st[:, 0] != 0).sum())} of "
                       f"{stashes.shape[0] * stashes.shape[2]} slots live")
            shares = ("" if mode == "delete" else
                      f"; {scan_shares(stats, int(va.sum()))}")
            print(f"   {name} case {label} ({how}): {int(va.sum())} lanes, "
                  f"{fails} failed{spilled}, kernel == plain bit for "
                  f"bit{shares}", flush=True)
        err[name] = 0
    return err


def sharded_stream(device: str, backend: str) -> list:
    """One seeded stream through the sharded filter -> the outputs of every
    step (tables, stashes, ok, deferred, overflow, hits, migration
    reports), as CPU tensors: 2 shards x 2^12 buckets x 4, a 128-slot
    stash, both routes, capacity factor 1.0 (routing defers), then (pair
    route) a split to 4 and a merge back with a cap that streams rounds."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core import hashing
    from repro_torch.distributed.elastic import (filter_mesh, merge_state,
                                                 split_state)
    rng = np.random.RandomState(SEED + 24)
    steps = []

    def step(label, state, *arrays):
        steps.append((label, [x.cpu() for x in (state.tables, state.stashes,
                                                *arrays)]))

    for route in ("key", "pair"):
        mesh = filter_mesh(2, device=device)
        state = dist.make_sharded_state(2, 1 << 12, 4, stash_slots=128,
                                        device=device)
        keys = random_keys(rng, 28_000)
        hi, lo = (torch.from_numpy(x.view(np.int32)).to(device)
                  for x in hashing.key_to_u32_pair_np(keys))
        kw = dict(fp_bits=16, backend=backend, route=route,
                  capacity_factor=1.0)
        for w in range(4):
            sl = slice(w * 7000, (w + 1) * 7000)
            state, ok, dfr, ov = dist.distributed_insert(
                mesh, "data", state, hi[sl], lo[sl], max_disp=64, **kw)
            step(f"{route} insert {w}", state, ok, dfr, ov)
        hit, ov = dist.distributed_lookup(mesh, "data", state, hi, lo, **kw)
        step(f"{route} lookup", state, hit, ov)
        if route == "pair":
            m4 = filter_mesh(4, device=device)
            state, rep = split_state(m4, "data", state)
            step("split", state, torch.tensor([rep.keys_moved, rep.rounds,
                                               rep.failed]))
            state, rep = merge_state(m4, "data", state, cap=2000)
            step("merge", state, torch.tensor([rep.keys_moved, rep.rounds,
                                               rep.failed]))
        state, dok, ddf, dov = dist.distributed_delete(
            mesh, "data", state, hi[:14_000], lo[:14_000], **kw)
        step(f"{route} delete", state, dok, ddf, dov)
    return steps


def sharded_parity() -> None:
    """Phase 3: the sharded stream on the card and on the CPU, equal bit for
    bit after every step, for both backends."""
    import torch
    from repro_torch.kernels import cuda
    for backend in ("cuda", "torch"):
        cuda.reset_counts()
        card = sharded_stream("cuda", backend)
        launches = dict(cuda.LAUNCHES)
        check(not cuda.PLAIN_CALLS, f"plain versions ran on the card "
                                    f"({backend}): {dict(cuda.PLAIN_CALLS)}")
        cpu = sharded_stream("cpu", backend)
        for (label, a), (_l, b) in zip(card, cpu):
            check(len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)),
                f"sharded stream ({backend}) {label}: card and CPU differ")
        rep = {label: x[-1].tolist() for label, x in card
               if label in ("split", "merge")}
        print(f"   sharded stream ({backend}): {len(card)} steps equal card "
              f"vs CPU; split / merge (moved, rounds, failed) {rep}; "
              f"launches {launches}", flush=True)
        want = ("probe", "scan_insert", "scan_delete") if backend == "torch" \
            else ("probe", "insert_bulk", "delete_bulk", "scan_insert")
        check(all(launches.get(k) for k in want),
              f"sharded stream ({backend}) never launched one of {want}")


class _Capture:
    """Wraps a scan wrapper where a module calls it, keeping a copy of the
    inputs of its largest call (most valid lanes)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.best, self.lanes = None, -1

    def __enter__(self):
        def spy(tables, a, b, **kw):
            valid = kw.get("valid")
            lanes = a.numel() if valid is None else int(valid.sum())
            if lanes > self.lanes:
                stashes = kw.get("stashes")
                self.lanes = lanes
                self.best = (tables.clone(), a.clone(), b.clone(),
                             {**kw, "valid": None if valid is None
                              else valid.clone(),
                              "stashes": None if stashes is None
                              else stashes.clone()})
            return self.fn(tables, a, b, **kw)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def sharded_node_path(card: str) -> dict:
    """Phase 5f: one sharded node set at node size (``SHARDED``), driven
    through the entry points a store's control plane calls: the pump writes
    SHARDED_KEYS distinct keys in waves, routed lookups of every key and as
    many absent ones, a live split to 4 shards and a merge back through
    ``ElasticController``, a snapshot, the loss of shard 1 (degraded
    lookups), its recovery, and routed deletes of half the keys; then the
    same node once more on the scan backend.  Fatal checks in each step;
    wall and device-busy time per step."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.ckpt import save_sharded
    from repro_torch.core import distributed as dist
    from repro_torch.core import filter as tfilter
    from repro_torch.core import hashing
    from repro_torch.core.metrics import theoretical_fp_rate
    from repro_torch.distributed import elastic
    from repro_torch.distributed.elastic import ElasticController, filter_mesh
    from repro_torch.distributed.fault import (FaultInjector,
                                               degraded_lookup, recover_shard)
    from repro_torch.kernels import cuda
    from repro_torch.obs import MetricsRegistry, RecoveryMetrics
    from repro_torch.serving.scheduler import DeferredWritePump

    cfg = SHARDED
    fp_bits, route, cf = cfg["fp_bits"], cfg["route"], cfg["capacity_factor"]
    rng = np.random.RandomState(SEED + 5)
    n_all = SHARDED_KEYS + SHARDED_CONCURRENT
    keys = np.unique(random_keys(rng, n_all + 4096))
    keys = rng.permutation(keys)[:n_all]
    absent = random_keys(rng, n_all + 4096)
    absent = absent[~np.isin(absent, keys)][:n_all]
    check(keys.size == absent.size == n_all, "key draw came short")
    hi_np, lo_np = hashing.key_to_u32_pair_np(keys)
    a_hi, a_lo = hashing.key_to_u32_pair_np(absent)

    def dev(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int32).copy()).cuda()

    times = {}

    def timed(label, fn):
        """Run ``fn`` under a CUDA-activity profile -> its result; record
        the wall and device-busy seconds."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = device_busy_s(prof)
        times[label] = (wall, busy)
        print(f"   [{card}] {label}: {wall!r} s wall, device busy {busy!r} s"
              f" (idle share {1 - busy / wall!r})", flush=True)
        return out

    def lookups(mesh, state, h, l, backend="cuda"):
        out = [dist.distributed_lookup(
            mesh, "data", state, dev(h[s:s + SHARDED_BATCH]),
            dev(l[s:s + SHARDED_BATCH]), fp_bits=fp_bits, backend=backend,
            route=route, capacity_factor=cf)[0]
            for s in range(0, h.size, SHARDED_BATCH)]
        return torch.cat(out).cpu().numpy()

    def live(state):
        return int((state.tables != 0).sum()
                   + (state.stashes[:, 0] != 0).sum())

    def arm(backend: str, reg):
        mesh = filter_mesh(cfg["n_shards"])
        state = dist.make_sharded_state(
            cfg["n_shards"], cfg["n_buckets"], cfg["bucket_size"],
            stash_slots=cfg["stash_slots"])
        pump = DeferredWritePump(mesh, "data", state, fp_bits=fp_bits,
                                 backend=backend, route=route,
                                 capacity_factor=cf, metrics=reg)

        def write():
            for s in range(0, SHARDED_KEYS, SHARDED_WAVE):
                pump.submit(hi_np[s:s + SHARDED_WAVE],
                            lo_np[s:s + SHARDED_WAVE])
                pump.run_until_drained()
            return pump.stats
        stats = timed(f"{backend}: pump writes {SHARDED_KEYS} keys in waves "
                      f"of {SHARDED_WAVE}", write)
        stats = dataclasses.replace(stats)
        print(f"   {backend}: {stats}, pending {pump.pending}, load "
              f"{float(dist.sharded_occupancy(pump.state))!r}", flush=True)
        check(stats.failed == 0 and pump.pending == 0
              and stats.inserted == SHARDED_KEYS,
              f"{backend}: the pump failed or left keys: {stats}")
        return mesh, pump

    # -- the kernel backend: writes, lookups, split, merge, loss, deletes --
    reg = MetricsRegistry()
    rec = RecoveryMetrics(metrics=reg)
    torch.cuda.synchronize()
    cuda.reset_counts()
    mesh2, pump = arm("cuda", reg)
    eps = theoretical_fp_rate(cfg["bucket_size"], fp_bits,
                              float(dist.sharded_occupancy(pump.state)))

    def check_lookups(mesh, state, label, n, fn_limit=0):
        hits = lookups(mesh, state, hi_np[:n], lo_np[:n])
        miss = lookups(mesh, state, a_hi[:n], a_lo[:n])
        fn, fp = int((~hits).sum()), int(miss.sum())
        print(f"   {label}: false negatives {fn}, false positives {fp} "
              f"(rate {fp / n!r}, 4 x theoretical {4 * eps!r}; the pair "
              f"owner takes log2(shards) bits of a fingerprint's entropy, "
              f"so expect about shards x theoretical)", flush=True)
        check(fn <= fn_limit, f"{label}: {fn} false negatives")
        check(fp / n <= 4 * eps, f"{label}: fp rate too high")
        return hits, miss

    timed(f"lookups of {2 * SHARDED_KEYS} keys (2 shards)",
          lambda: check_lookups(mesh2, pump.state, "2 shards", SHARDED_KEYS))
    ctrl = ElasticController(pump, axis="data", recovery=rec)
    live0 = live(pump.state)
    m4 = filter_mesh(4)
    pump.hold()            # the concurrent stream parks mid-cutover
    ok, dfr = pump.submit(hi_np[SHARDED_KEYS:], lo_np[SHARDED_KEYS:])
    check(not ok.any() and bool(dfr.all())
          and pump.pending == SHARDED_CONCURRENT,
          "the held pump did not park the concurrent stream")
    with _Capture(elastic, "scan_insert") as scap:
        rep = timed("split 2 -> 4 (ElasticController)",
                    lambda: ctrl.split(m4))
    print(f"   split: {rep}; backlog after {pump.pending}, {pump.stats}",
          flush=True)
    st4 = pump.state
    check(rep.failed == 0, f"the split failed {rep.failed} lanes")
    check(pump.pending == 0 and pump.stats.failed == 0
          and pump.stats.inserted == n_all,
          f"the parked stream did not drain after the split: {pump.stats}")
    # Each acknowledged insert adds one live entry, so the split conserved
    # the live entries when the count grew by exactly the parked stream.
    live0 += SHARDED_CONCURRENT
    check(live(st4) == live0, "the split did not conserve live entries")
    eps = theoretical_fp_rate(cfg["bucket_size"], fp_bits,
                              2 * float(dist.sharded_occupancy(st4)))
    nb = cfg["n_buckets"]
    for s in range(4):
        t = st4.tables[s].reshape(-1)
        rows = torch.arange(st4.tables.shape[1], device=t.device
                            ).repeat_interleave(cfg["bucket_size"])
        occ = t != 0
        s_occ = st4.stashes[s, 0] != 0
        owner = torch.cat([
            hashing.owner_shard_pair(rows[occ], t[occ], nb, 4),
            hashing.owner_shard_pair(st4.stashes[s, 1][s_occ],
                                     st4.stashes[s, 0][s_occ], nb, 4)])
        check(bool((owner == s).all()),
              f"shard {s} holds entries it does not own after the split")
    timed(f"lookups of {2 * n_all} keys (4 shards)",
          lambda: check_lookups(m4, st4, "4 shards", n_all))
    with _Capture(elastic, "scan_insert") as cap:
        rep = timed("merge 4 -> 2 (ElasticController)",
                    lambda: ctrl.merge(mesh2))
    print(f"   merge: {rep}", flush=True)
    check(live0 == live(pump.state) + rep.failed,
          "the merge did not conserve live entries")
    healthy = timed(f"lookups of {2 * n_all} keys (merged)",
                    lambda: check_lookups(mesh2, pump.state, "merged", n_all,
                                          fn_limit=rep.failed))
    migration = {"split_s": times["split 2 -> 4 (ElasticController)"][0],
                 "merge_s": times["merge 4 -> 2 (ElasticController)"][0],
                 "merge_lanes": cap.lanes, "merge_failed": rep.failed,
                 "merge_rounds": rep.rounds, "merge_moved": rep.keys_moved}

    # -- loss of shard 1 and its recovery from a snapshot --
    state = pump.state
    with tempfile.TemporaryDirectory() as tmp:
        timed("save_sharded", lambda: save_sharded(tmp, 1, state))
        inj = FaultInjector(recovery=rec)
        dead = inj.kill(state, 1)

        def degraded():
            outs = [degraded_lookup(
                mesh2, "data", dead, dev(h[s:s + SHARDED_BATCH]),
                dev(l[s:s + SHARDED_BATCH]), fp_bits=fp_bits, injector=inj,
                route=route, capacity_factor=cf, recovery=rec)
                for h, l in ((hi_np, lo_np), (a_hi, a_lo))
                for s in range(0, h.size, SHARDED_BATCH)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[2] for o in outs]))
        out, deg = timed("degraded lookups (shard 1 lost)", degraded)
        owner = np.concatenate([hashing.owner_shard_key_pair_np(
            h, l, nb, fp_bits, 2) for h, l in ((hi_np, lo_np),
                                                (a_hi, a_lo))])
        want = np.concatenate(healthy)
        check(bool((deg == (owner == 1)).all()),
              "degraded_lookup flagged other keys than shard 1's")
        check(bool(out[deg].all()), "a lost shard's key answered False")
        check(bool((out[~deg] == want[~deg]).all()),
              "a surviving shard's answer changed")
        back = timed("recover_shard 1", lambda: recover_shard(
            dead, 1, ckpt_dir=tmp, injector=inj, recovery=rec))
    after = np.concatenate([lookups(mesh2, back, hi_np, lo_np),
                            lookups(mesh2, back, a_hi, a_lo)])
    check(bool((after == want).all()),
          "recovery did not bring every answer back")
    print(f"   shard loss: {int(deg.sum())} degraded answers, recovered in "
          f"{times['recover_shard 1'][0]!r} s; every answer back",
          flush=True)

    # -- routed deletes of half the keys --
    half = n_all // 2

    def deletes(mesh, state, backend):
        oks = []
        for s in range(0, half, SHARDED_BATCH):
            e = min(half, s + SHARDED_BATCH)
            state, ok, dfr, _ov = dist.distributed_delete(
                mesh, "data", state, dev(hi_np[s:e]), dev(lo_np[s:e]),
                fp_bits=fp_bits, backend=backend, route=route,
                capacity_factor=cf, donate=True)
            oks.append(ok.cpu().numpy())
        return state, np.concatenate(oks)
    back, dok = timed(f"deletes of {half} keys",
                      lambda: deletes(mesh2, back, "cuda"))
    check(bool(dok.all()), f"{int((~dok).sum())} verified deletes refused")
    rest = lookups(mesh2, back, hi_np[half:n_all], lo_np[half:n_all])
    check(bool(rest.all()), f"{int((~rest).sum())} false negatives after "
                            f"the deletes")
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    plain = dict(cuda.PLAIN_CALLS)
    print(f"   launches (kernel backend) {launches} plain_calls {plain}",
          flush=True)
    missing = [k for k in ("probe", "insert_bulk", "delete_bulk",
                           "scan_insert") if not launches.get(k)]
    check(not missing, f"phase 5f never launched {missing}")
    del pump, ctrl, st4, state, dead, back
    gc.collect()
    torch.cuda.empty_cache()

    # -- the same node on the scan backend: writes, lookups, deletes --
    cuda.reset_counts()
    with _Capture(tfilter, "scan_insert") as icap:
        mesh_s, pump_s = arm("torch", None)
    hits = timed("scan backend: lookups of the keys",
                 lambda: lookups(mesh_s, pump_s.state, hi_np[:SHARDED_KEYS],
                                 lo_np[:SHARDED_KEYS], backend="torch"))
    check(bool(hits.all()), "scan backend: false negatives")
    half = SHARDED_KEYS // 2
    with _Capture(tfilter, "scan_delete") as dcap:
        st, dok = timed(f"scan backend: deletes of {half} keys",
                        lambda: deletes(mesh_s, pump_s.state, "torch"))
    check(bool(dok.all()), "scan backend: a verified delete was refused")
    rest = lookups(mesh_s, st, hi_np[half:SHARDED_KEYS],
                   lo_np[half:SHARDED_KEYS], backend="torch")
    check(bool(rest.all()), "scan backend: false negatives after deletes")
    torch.cuda.synchronize()
    s_launches = dict(cuda.LAUNCHES)
    plain = dict(collections.Counter(plain) + collections.Counter(
        cuda.PLAIN_CALLS))
    print(f"   launches (scan backend) {s_launches}", flush=True)
    check(all(s_launches.get(k) for k in ("probe", *SCAN_KERNELS)),
          f"the scan backend never launched one of probe, {SCAN_KERNELS}")
    counts = collections.Counter(launches)
    counts.update(s_launches)
    del pump_s, st
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": dict(counts), "plain": plain, "times": times,
            "migration": migration, "split_input": scap.best,
            "merge_input": cap.best,
            "insert_input": icap.best, "delete_input": dcap.best}


def scan_work(tables, after, a, b, valid, *, mode, n_buckets, stashes=None):
    """(bytes, ops) a walk needs for this run's data: the mask once, each
    walked lane's two words and ok byte, the home bucket's sector of every
    walked lane, every changed sector written once (and the stash, with
    one); the hash (key mode) or the alternate index (pair mode) a walked
    lane."""
    import torch
    from repro_torch.core import hashing
    v = valid
    if mode == "pair":
        i1 = hashing.to_u32(a[v]) % n_buckets
        ops = 20 * int(v.sum())
    else:
        i1 = hashing.index_hash(a[v], b[v], n_buckets)
        ops = HASH_OPS * int(v.sum())
    shard = torch.nonzero(v)[:, 0]
    rows = shard * tables.shape[1] + i1
    changed = (tables != after).any(dim=2).reshape(-1).nonzero().flatten()
    nbytes = (valid.numel() + 9 * int(v.sum())
              + SECTOR * (sectors(rows) + sectors(changed)))
    if stashes is not None:
        nbytes += 2 * stashes.numel() * 4
    return nbytes, ops


def scan_kernel_times(captured: dict) -> dict:
    """Phase 6 rows of the scan kernels at their path's launches: the
    merge's receive walk (``scan_insert``, pair mode, every receiving shard
    in one launch), the split's receive walk (the same, 4 shards; its
    figures go in the row's ``split_*`` fields), the scan backend's largest
    insert residue (``scan_insert`` key mode, one 2^20-bucket shard;
    ``key_*`` fields) and its largest delete launch (``scan_delete``): each
    held against its plain version bit for bit, then timed (device ms by
    the profiler, the wrapper by CUDA events; the plain version once, by
    the host clock, so long is its walk).  Each insert launch also reports
    its schedule (shares of lanes taken direct, taken as chain records,
    walked because dirty, walked as chains); the delete its conflict groups
    and the grouping's ms (``delete_groups``, CUDA events) apart from the
    walk's."""
    import torch
    from repro_torch.kernels.scan import (delete_groups, scan_delete,
                                          scan_delete_plain, scan_insert,
                                          scan_insert_plain)
    out = {}
    for label, key, kern_fn, plain_fn in (
            ("scan_insert", "merge_input", scan_insert, scan_insert_plain),
            ("scan_insert_split", "split_input", scan_insert,
             scan_insert_plain),
            ("scan_insert_key", "insert_input", scan_insert,
             scan_insert_plain),
            ("scan_delete", "delete_input", scan_delete, scan_delete_plain)):
        name = label.removesuffix("_key").removesuffix("_split")
        tables0, a, b, kw = captured[key]
        tables = tables0.clone()
        stashes0 = kw.get("stashes")
        stashes = None if stashes0 is None else stashes0.clone()
        t3 = tables if tables.dim() == 3 else tables[None]
        valid = kw["valid"]
        if valid is None:
            valid = torch.ones(a.shape, dtype=torch.bool, device=a.device)
        v3 = valid if valid.dim() == 2 else valid[None]
        a3 = a if a.dim() == 2 else a[None]
        b3 = b if b.dim() == 2 else b[None]
        s3 = None if stashes is None else (
            stashes if stashes.dim() == 3 else stashes[None])
        mode = kw.get("mode", "key")
        args = {k: v for k, v in kw.items()
                if k in ("n_buckets", "fp_bits", "max_disp", "mode")}
        if name == "scan_insert":
            args.setdefault("fp_bits", None)
        stats = torch.zeros(4, dtype=torch.int64, device=tables.device)

        def setup():
            tables.copy_(tables0)
            if stashes is not None:
                stashes.copy_(stashes0)
            stats.zero_()

        def kern():
            ok = kern_fn(tables, a, b, valid=valid, stashes=stashes,
                         stats=stats, **args) \
                if name == "scan_insert" else \
                kern_fn(tables, a, b, valid=valid, **args)
            return [tables, *([] if stashes is None else [stashes]), ok]

        def plain():
            ok = plain_fn(t3, a3, b3, v3, stashes=s3, **args) \
                if name == "scan_insert" else plain_fn(t3, a3, b3, v3, **args)
            ok = ok if valid.dim() == 2 else ok[0]
            return [tables, *([] if stashes is None else [stashes]), ok]

        setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = [t.clone() for t in plain()]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        setup()
        got = [t.clone() for t in kern()]
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"{label} at the path's launch: the kernel differs from the "
              f"plain version")
        walked = int(valid.sum())
        nbytes, ops = scan_work(t3, got[0] if got[0].dim() == 3
                                else got[0][None], a3, b3, v3,
                                mode=mode, n_buckets=args["n_buckets"],
                                stashes=s3)
        bound_ms, bound_by = least_ms(nbytes, ops)
        schedule = ""
        if name == "scan_insert":
            schedule = f"; schedule {scan_shares(stats, walked)}"
            shares = stats.tolist()
        d = kernel_device_ms(kern, 2, setup, name + "_kernel")
        check(d is not None, f"{name}: no device time in the trace")
        w = time_ms(kern, 2, setup)
        row = {"ms": d, "wrapper_ms": w, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "ops": ops, "lanes": walked,
               "us_per_lane": d * 1e3 / max(walked, 1),
               "shards": t3.shape[0]}
        if name == "scan_insert":
            row["schedule"] = dict(zip(("direct", "chain", "dirty",
                                        "walked"), shares))
        else:
            groups = delete_groups(a3, b3, v3, n_buckets=args["n_buckets"],
                                   fp_bits=args["fp_bits"])[4]
            row["groups"] = int((groups[1:] != groups[:-1]).sum()) + 1
            row["group_ms"] = time_ms(lambda: delete_groups(
                a3, b3, v3, n_buckets=args["n_buckets"],
                fp_bits=args["fp_bits"]), 3)
            schedule = (f"; {row['groups']} conflict groups, grouping "
                        f"{row['group_ms']!r} ms (CUDA events)")
        out[label] = row
        tag = f" ({mode} mode)" if name == "scan_insert" else ""
        print(f"   {label}{tag}: held at the path's launch "
              f"({t3.shape[0]} shards, {walked} walked lanes of "
              f"{a.numel()}), kernel {d!r} ms "
              f"(device), {d * 1e3 / max(walked, 1)!r} us a walked lane, "
              f"wrapper {w!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} "
              f"ms ({bound_by}: {nbytes} B, {ops} ops){schedule}",
              flush=True)
    for prefix, label in (("key", "scan_insert_key"),
                          ("split", "scan_insert_split")):
        row = out.pop(label)
        out["scan_insert"].update({f"{prefix}_{k}": row[k] for k in (
            "lanes", "ms", "us_per_lane", "plain_ms", "bound_ms",
            "schedule")})
    return out


# ------------------------------------------------- the training path --

# Phase 2: the backward kernels against their plain version, |got - want|
# <= tol * (1 + |want|) elementwise, and row by row ||got - want|| /
# ||want|| over the rows whose norm is above 1e-3 of the tensor's largest
# row and above 1e-3 (the inputs are O(1); a row below that, such as dq
# of a query whose one live key is itself, 0 in exact arithmetic, is held
# by the elementwise check alone).  float32: dk and dv sum 4 heads x up
# to 8192 rows a key in another order than the plain version, so an
# element that cancels to ~0.1 carries ~sqrt(32768) float32 roundings of
# O(1) terms (observed 3.1e-5 absolute; 5e-6 row-relative); bfloat16:
# both round the float32 gradient to bfloat16 once (observed 4e-3
# absolute, 1.3e-3 by row).
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FLASH_BWD_ROW_TOL = {"float32": 5e-5, "bfloat16": 1e-2}
TRAIN_KERNELS = ("flash_attention_bwd_pre", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq")
# Phase 5i: gemma3-1b at full width and depth, SHAPES["train_4k"]'s
# sequence of 4096; its global batch of 256 cut to TRAIN_BATCH sequences
# (what one card holds: the 262144-wide float32 logits of a microbatch of
# 2 sequences are 8.6 GB, and log-softmax and their gradients as much
# again), in TRAIN_MICRO microbatches, remat TRAIN_REMAT.
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_MICRO = 2
TRAIN_REMAT = "full"
TRAIN_STEPS = 5
# 5i resume: a run killed at the start of step TRAIN_FAIL_AT after a
# checkpoint at step TRAIN_CKPT resumes there; its first two steps' losses
# within TRAIN_RESUME_TOL (relative) of the uninterrupted run's: the same
# parameters, optimizer state and batches, but the embedding gradient
# sums rows with atomics, so parameters may differ in their last bits
# once a step has updated them.
TRAIN_CKPT = 2
TRAIN_FAIL_AT = 2
TRAIN_RESUME_TOL = 1e-4
# Phase 3: one step card vs CPU at full width, 6 layers, float32, TF32
# off.  Gradients leaf by leaf, ||got - want|| / ||want|| <= 1e-3
# (float32 sums in other orders through 6 layers and the 262144-wide
# softmax; the card sums the embedding gradient's rows with atomics);
# loss and grad_norm within 1e-4 relative; parameters after the step
# within 2 lr absolute: Adam's first step moves each weight by about lr
# times the sign of its gradient, and a gradient near 0 may take the
# other sign on the other device.
TRAIN_GRAD_TOL = 1e-3


def grad_errs(got, want, tol: float, row_tol: float | None,
              what: str) -> float:
    """Check ``got`` against ``want`` elementwise and (unless ``row_tol``
    is None) row by row (see FLASH_BWD_TOL) -> the max absolute error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    m = float(err.max()) if err.numel() else 0.0
    excess = float((err - tol * (1 + w.abs())).max()) if err.numel() else 0
    rel = 0.0
    if row_tol is not None and w.numel():
        num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
        rows = den > 1e-3 * max(float(den.max()), 1.0)
        if bool(rows.any()):
            rel = float((num[rows] / den[rows]).max())
    print(f"      {what}: max_abs_err {m!r} (max |want| "
          f"{float(w.abs().max())!r}), row relative error {rel!r}",
          flush=True)
    check(excess <= 0, f"{what}: outside {tol} x (1 + |want|) by {excess}")
    check(row_tol is None or rel <= row_tol,
          f"{what}: row relative error {rel} > {row_tol}")
    return m


class FlashBwdBench:
    """flash attention's backward kernels on the card against their plain
    version (``flash_attention_bwd_plain``, on the same forward output and
    ``lse``): every shape of FlashKernelBench.CASES (D 16 to 256, float32
    and bfloat16, causal, window, soft-cap, GQA, ragged lengths, rows with
    no live key), gemma3-1b's training shapes (bfloat16, Hq 4, Hkv 1, D
    256, S = TRAIN_SEQ, window 512 and global, B 1 and the microbatch's B
    2), gemma3-1b's heads at D 64 and 128 and a soft-capped, windowed,
    ragged D 256 case (BF16_CASES: the wgmma kernels' head dims), and
    deepseek-v2-lite's MLA heads through ``ops.attention`` under autograd
    (padded to 256); the pre-pass against ``bwd_delta_plain``; the
    forward's ``lse`` against the plain version's.  In float32 the kernels
    are also held against ``torch.autograd.grad`` through the plain
    forward; in bfloat16 a second run must give the same bits (no
    atomics: each output element is summed in a fixed order)."""

    TRAIN_CASES = [(1, 4, 1, TRAIN_SEQ, TRAIN_SEQ, 256, True, 512, None),
                   (1, 4, 1, TRAIN_SEQ, TRAIN_SEQ, 256, True, None, None),
                   (2, 4, 1, TRAIN_SEQ, TRAIN_SEQ, 256, True, 512, None),
                   (2, 4, 1, TRAIN_SEQ, TRAIN_SEQ, 256, True, None, None)]
    BF16_CASES = [(1, 4, 1, 1000, 1000, 64, True, None, None),
                  (2, 4, 1, 1000, 1000, 128, True, 200, None),
                  (1, 4, 1, 300, 300, 256, True, 100, 30.0),
                  (1, 2, 1, 100, 250, 128, False, 70, None)]

    def __init__(self):
        import torch
        self.torch = torch
        self.max_err = {k: 0.0 for k in TRAIN_KERNELS}

    def _note(self, name: str, err: float) -> None:
        self.max_err[name] = max(self.max_err[name], err)

    def run(self) -> None:
        torch = self.torch
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 30)
        both = (torch.float32, torch.bfloat16)
        cases = [(c, both) for c in FlashKernelBench.CASES] + \
            [(c, (torch.bfloat16,))
             for c in self.TRAIN_CASES + self.BF16_CASES]
        for case, dtypes in cases:
            for dtype in dtypes:
                self.one(case, dtype, gen)
        self.run_mla(gen)

    def one(self, case, dtype, gen) -> None:
        torch = self.torch
        from repro_torch.kernels.flash_attention import (
            _flash_cuda, bwd_delta, bwd_delta_plain, flash_attention_bwd,
            flash_attention_bwd_plain, flash_attention_plain)
        b, hq, hkv, sq, skv, d, causal, window, cap = case
        name = str(dtype).split(".")[-1]
        tol, row_tol = FLASH_BWD_TOL[name], FLASH_BWD_ROW_TOL[name]

        def randn(*shape):
            return torch.randn(shape, device="cuda", generator=gen).to(dtype)
        q, k, v = randn(b, hq, sq, d), randn(b, hkv, skv, d), \
            randn(b, hkv, skv, d)
        do = randn(b, hq, sq, d)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        with torch.no_grad():
            o, lse = _flash_cuda(q, k, v, scale=None, with_lse=True, **kw)
            _po, plse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        live = plse > -1e29
        lse_err = float((lse - plse)[live].abs().max()) if bool(
            live.any()) else 0.0
        print(f"   flash backward {case} {name}: forward lse max_abs_err "
              f"{lse_err!r} over live rows; dead rows at -1e30: "
              f"{bool((lse[~live] == -1e30).all())}", flush=True)
        check(lse_err <= 1e-4 * (1 + float(plse[live].abs().max()))
              if bool(live.any()) else True, f"{case}: lse off by {lse_err}")
        check(bool((lse[~live] == -1e30).all()), f"{case}: a dead row's lse")
        torch.cuda.synchronize()
        delta = bwd_delta(o, do)
        # D sums D products of O(1) values in another order: 1e-5; one
        # number a row, so no row check
        self._note("flash_attention_bwd_pre", grad_errs(
            delta, bwd_delta_plain(o, do), 1e-5, None, "pre-pass D"))
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
            same = [bool(torch.equal(a, b)) for a, b in zip(got, again)]
            print(f"      a second run gives the same bits (dq, dk, dv): "
                  f"{same}", flush=True)
            check(all(same), f"{case}: two runs of the backward differ")
            del again
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for label, g, w, kern in zip(("dq", "dk", "dv"), got, want,
                                     ("flash_attention_bwd_dq",
                                      "flash_attention_bwd_dkdv",
                                      "flash_attention_bwd_dkdv")):
            check(g.dtype == dtype and g.shape == w.shape,
                  f"{case}: {label} {g.dtype} {tuple(g.shape)}")
            self._note(kern, grad_errs(g, w, tol, row_tol,
                                       f"{label} vs plain"))
        if causal and skv < sq:
            check(float(got[0][:, :, :sq - skv].abs().max()) == 0.0,
                  f"{case}: dq of a row with no live key is not 0")
        if dtype == torch.float32:
            # torch.autograd.grad through the plain forward's torch ops
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*leaves, **kw)
            ag = torch.autograd.grad(out, leaves, do)
            for label, g, w in zip(("dq", "dk", "dv"), got, ag):
                grad_errs(g, w, tol, row_tol,
                          f"{label} vs autograd of the plain forward")
            del leaves, out, ag

    def run_mla(self, gen) -> None:
        """MLA's heads through ``ops.attention`` under autograd: one
        forward and three backward launches, the gradients through the
        zero pad and the slice, held against the plain backward on the
        padded heads cut back, from the forward kernel's own output and
        ``lse`` (in bfloat16 dS = p (dP - D) cancels, so D from another
        rounding of o would move the small rows of dq by more than the
        row tolerance)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import cuda, ops
        from repro_torch.kernels.flash_attention import (
            _flash_cuda, flash_attention_bwd_plain)
        for case in FlashKernelBench.MLA_CASES:
            b, h, s, dk, dv, name = case
            dtype = getattr(torch, name)
            tol, row_tol = FLASH_BWD_TOL[name], FLASH_BWD_ROW_TOL[name]
            q, k, v = (torch.randn(shape, device="cuda", generator=gen)
                       .to(dtype).requires_grad_()
                       for shape in ((b, h, s, dk), (b, h, s, dk),
                                     (b, h, s, dv)))
            do = torch.randn((b, h, s, dv), device="cuda",
                             generator=gen).to(dtype)
            before = dict(cuda.LAUNCHES)
            out = ops.attention(q, k, v, scale=dk ** -0.5)
            got = torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            launched = {n: cuda.LAUNCHES[n] - before.get(n, 0)
                        for n in ("flash_attention", *TRAIN_KERNELS)}
            check(set(launched.values()) == {1},
                  f"MLA {case}: launches {launched}")

            def pad(t):
                return F.pad(t.detach(), (0, 256 - t.shape[-1]))
            pq, pk, pv, pdo = pad(q), pad(k), pad(v), pad(do)
            with torch.no_grad():
                po, plse = _flash_cuda(pq, pk, pv, causal=True, window=None,
                                       logit_softcap=None, scale=dk ** -0.5,
                                       with_lse=True)
                want = flash_attention_bwd_plain(pq, pk, pv, po, plse, pdo,
                                                 scale=dk ** -0.5)
            print(f"   flash backward MLA {case} through ops.attention, "
                  f"padded to 256: launches {launched}", flush=True)
            for label, g, w, width in zip(("dq", "dk", "dv"), got, want,
                                          (dk, dk, dv)):
                check(g.shape[-1] == width, f"MLA {case}: {label} width")
                err = grad_errs(g, w[..., :width], tol, row_tol,
                                f"{label} vs plain")
                self._note("flash_attention_bwd_dq" if label == "dq"
                           else "flash_attention_bwd_dkdv", err)


def train_grads(model, batch: dict):
    """One ``make_train_step`` step of ``model`` from a fresh AdamW state ->
    (metrics as floats, the gradients it took, its launch and plain-call
    counts, the step's learning rate).  The gradients are read where the
    step hands them to ``AdamW.update``."""
    import torch
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.kernels import cuda
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import make_train_step
    seen = {}

    class Capture(AdamW):
        def update(self, grads, state, params):
            seen.update({k: g.detach().float().cpu()
                         for k, g in grads.items()})
            return super().update(grads, state, params)
    tx = Capture(lr=cosine_schedule(3e-4, 20, 10000))
    params = dict(model.named_parameters())
    step = make_train_step(model, tx, ParallelConfig())
    cuda.reset_counts()
    _p, state, metrics = step(params, tx.init(params), batch)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()}, seen,
            dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS),
            float(tx._lr(state.step)))


def train_parity() -> None:
    """Phase 3: one training step card vs CPU.  gemma3-1b at full width,
    one period deep (6 layers: 5 local, 1 global), float32, TF32 off, one
    seeded init on the CPU copied to the card, a batch of 2 x 256 tokens,
    a fresh AdamW state on both (the training schedule's step-1 learning
    rate): loss, grad_norm, every gradient leaf and every parameter after
    the step (TRAIN_GRAD_TOL and 2 lr); the card's step launches the flash
    forward and the three backward kernels once per layer and no plain
    version.  Then the OCF-dedup data pipeline on the card and on the CPU
    (shards of 16 docs, so shards retire): the same batches, the same
    ``PipelineStats`` and OCF stats, and the card's filter launched the
    fingerprint, probe, insert and delete kernels."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import Transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=6,
                              dtype="float32")
    cpu = Transformer(cfg, seed=SEED, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    rng = np.random.RandomState(SEED + 20)
    flat = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 257)))
    batch = {"tokens": flat[:, :-1], "targets": flat[:, 1:]}
    t0 = time.perf_counter()
    got, g_card, launches, plain, lr = train_grads(
        card, {k: v.cuda() for k, v in batch.items()})
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, g_cpu, _l, _p, _lr = train_grads(cpu, batch)
    t_cpu = time.perf_counter() - t0
    print(f"   train step {cfg.name} x{cfg.n_layers} layers, float32, "
          f"batch 2 x 256: card {t_card!r} s, cpu {t_cpu!r} s; loss "
          f"{got['loss']!r} / {want['loss']!r}, grad_norm "
          f"{got['grad_norm']!r} / {want['grad_norm']!r}", flush=True)
    for key in ("loss", "grad_norm"):
        check(abs(got[key] - want[key]) <= 1e-4 * abs(want[key]),
              f"train step: {key} {got[key]} vs {want[key]}")
    worst = max(((float((g_card[k] - g_cpu[k]).norm())
                  / max(float(g_cpu[k].norm()), 1e-30)), k) for k in g_cpu)
    print(f"   gradients of {len(g_cpu)} leaves: worst ||card - cpu|| / "
          f"||cpu|| {worst[0]!r} ({worst[1]}), limit {TRAIN_GRAD_TOL}",
          flush=True)
    check(worst[0] <= TRAIN_GRAD_TOL, f"gradient {worst[1]}: {worst[0]}")
    moved = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(card.parameters(), cpu.parameters()))
    print(f"   parameters after the step: max |card - cpu| {moved!r} "
          f"(limit 2 lr = {2 * lr!r})", flush=True)
    check(moved <= 2 * lr, f"parameters differ by {moved} > 2 lr")
    want_launch = {"flash_attention": 6, **{k: 6 for k in TRAIN_KERNELS}}
    print(f"   card step launches {launches}, plain {plain}", flush=True)
    check(all(launches.get(k) == n for k, n in want_launch.items()),
          f"train step launches {launches}, want {want_launch}")
    check(not plain, f"plain versions ran in the card's step: {plain}")
    del card, cpu, g_card, g_cpu
    free_card()
    dedup_parity()


def dedup_parity(batches: int = 60) -> None:
    """The OCF-dedup pipeline card vs CPU (see ``train_parity``)."""
    import itertools
    from repro_torch.data.pipeline import DedupPipeline, SyntheticDocs
    from repro_torch.kernels import cuda
    runs = {}
    for dev in ("cuda", "cpu"):
        pipe = DedupPipeline(SyntheticDocs(262144, doc_len=65, seed=SEED,
                                           burst=16),
                             batch=2, seq=64, shard_docs=16, device=dev)
        cuda.reset_counts()
        out = [b for b in itertools.islice(iter(pipe), batches)]
        runs[dev] = (pipe, out, dict(cuda.LAUNCHES))
    (cp, cb, launches), (hp, hb, _l) = runs["cuda"], runs["cpu"]
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(cb, hb)
               for k in ("tokens", "targets"))
    stats = dataclasses.asdict(cp.stats)
    print(f"   dedup pipeline, {batches} batches card vs cpu: batches equal "
          f"{same}; stats {stats} / {dataclasses.asdict(hp.stats)}; OCF "
          f"stats {dataclasses.asdict(cp.ocf.stats)}; card launches "
          f"{launches}", flush=True)
    check(same, "dedup pipeline: batches differ between devices")
    check(stats == dataclasses.asdict(hp.stats), "PipelineStats differ")
    check(dataclasses.asdict(cp.ocf.stats) == dataclasses.asdict(
        hp.ocf.stats), "the dedup OCF's stats differ")
    check(cp.stats.shards_retired > 0 and cp.stats.docs_deduped > 0,
          "no shard retired or no doc deduped")
    missing = [k for k in STATIC_KERNELS if not launches.get(k)]
    check(not missing, f"the dedup filter never launched {missing}")


def train_class(name: str) -> str:
    key = name.lower()
    if "flash_bwd" in key:
        return "flash_bwd"
    if "flash_" in key:
        return "flash_fwd"
    if any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "products"
    return "elementwise"


def train_path(card: str) -> dict:
    """Phase 5i: training gemma3-1b at full width and depth on the card
    through ``launch.train.train`` (26 layers, float32 weights from SEED,
    bfloat16 activations, the OCF-dedup pipeline on the card): (a)
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MICRO
    microbatches, remat TRAIN_REMAT: every loss and grad_norm finite, peak
    memory under 80 GB, the flash forward and backward launch counts per
    step what 26 layers, the microbatches and remat give, no plain
    version; step seconds and tokens/s; (b) one more step under a trace:
    device busy by class (flash forward, flash backward, matrix products,
    elementwise); (c) a run killed at step TRAIN_FAIL_AT after a
    checkpoint at TRAIN_CKPT resumes from it: its steps' losses match the
    uninterrupted run's (TRAIN_RESUME_TOL)."""
    import shutil
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.sharding import ParallelConfig
    from repro_torch.kernels import cuda
    from repro_torch.launch.train import train
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import make_train_step
    from repro_torch.configs import get_config
    par = ParallelConfig(remat=TRAIN_REMAT, microbatches=TRAIN_MICRO)
    n_layers = get_config(LM_ARCH).n_layers
    passes = 2 if TRAIN_REMAT in ("full", "dots") else 1
    print(f"   cut: SHAPES['train_4k'] = (4096, 256): the global batch of "
          f"256 sequences cut to {TRAIN_BATCH} (one card), "
          f"{TRAIN_MICRO} microbatches of {TRAIN_BATCH // TRAIN_MICRO}, "
          f"remat {TRAIN_REMAT!r}, {TRAIN_STEPS} steps", flush=True)
    free_card()
    cuda.reset_counts()
    t0 = time.perf_counter()
    out = train(LM_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                smoke=False, device="cuda", parallel=par)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    secs = out["step_seconds"]
    best = min(secs[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"   (a) {TRAIN_STEPS} steps in {wall!r} s [{card}]: losses "
          f"{losses}, grad_norms {norms}", flush=True)
    print(f"   (a) step seconds {secs} (first includes warm-up); min after "
          f"the first {best!r} s = {tokens / best!r} tokens/s; peak device "
          f"memory {peak} B", flush=True)
    print(f"   (a) dedup: {out['pipeline_stats']}; OCF "
          f"{out['dedup_ocf_stats']}; straggler flags "
          f"{out['straggler_flags']}", flush=True)
    per_step = {"flash_attention": n_layers * TRAIN_MICRO * passes,
                **{k: n_layers * TRAIN_MICRO for k in TRAIN_KERNELS}}
    print(f"   (a) launches {launches} (per step: {per_step}), plain "
          f"{plain}", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "5i: a loss or grad_norm is not finite")
    check(peak < PEAK_BYTES, f"5i: peak device memory {peak} B")
    for k, n in per_step.items():
        check(launches.get(k, 0) == n * TRAIN_STEPS,
              f"5i: {k} launched {launches.get(k, 0)} times, want "
              f"{n * TRAIN_STEPS}")
    check(sum(plain.values()) == 0, f"5i: plain versions ran: {plain}")

    # (b) one more step under a CUDA-activity trace
    model, params, state = out["model"], out["params"], out["opt_state"]
    step = make_train_step(model, AdamW(lr=cosine_schedule(3e-4, 20, 10000)),
                           par)
    rng = np.random.RandomState(SEED + 40)
    flat = torch.from_numpy(rng.randint(0, model.cfg.vocab_size,
                                        (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    batch = {"tokens": flat[:, :-1], "targets": flat[:, 1:]}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _p, _s, metrics = step(params, state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t1) * 1e3
    by = {"flash_fwd": 0.0, "flash_bwd": 0.0, "products": 0.0,
          "elementwise": 0.0}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by[train_class(ev.name)] += (ev.time_range.end
                                         - ev.time_range.start) / 1e3
    busy = sum(by.values())
    print(f"   (b) profile of one step [{card}]: {pwall!r} ms host clock "
          f"(under the profiler), device busy {busy!r} ms: flash forward "
          f"{by['flash_fwd']!r}, flash backward {by['flash_bwd']!r}, matrix "
          f"products {by['products']!r}, elementwise and the rest "
          f"{by['elementwise']!r}; idle share {1 - busy / pwall!r}",
          flush=True)
    result = {"losses": losses, "grad_norms": norms, "step_seconds": secs,
              "tokens_per_s": tokens / best, "peak_bytes": peak,
              "launches": launches, "per_step": per_step,
              "profile_ms": pwall, "device_ms": by,
              "pipeline_stats": dataclasses.asdict(out["pipeline_stats"])}
    del out, model, params, state, step, batch, flat, prof, _p, _s
    free_card()

    # (c) checkpoint, failure, resume
    ckpt = str(Path(__file__).resolve().parent / "build" / "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, smoke=False, device="cuda",
              parallel=par, ckpt_dir=ckpt)
    t0 = time.perf_counter()
    try:
        train(LM_ARCH, steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT,
              inject_failure_at=TRAIN_FAIL_AT, **kw)
        check(False, "5i: the injected failure did not fire")
    except RuntimeError as exc:
        check("injected" in str(exc), f"5i: {exc}")
    t_fail = time.perf_counter() - t0
    free_card()
    t0 = time.perf_counter()
    resumed = train(LM_ARCH, steps=TRAIN_FAIL_AT + 2, ckpt_every=1000, **kw)
    t_resume = time.perf_counter() - t0
    got = [h["loss"] for h in resumed["history"]]
    want = losses[TRAIN_CKPT:TRAIN_FAIL_AT + 2]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"   (c) killed at step {TRAIN_FAIL_AT} after a checkpoint at "
          f"step {TRAIN_CKPT} ({t_fail!r} s with the save), resumed "
          f"({t_resume!r} s with the restore): losses {got} vs the "
          f"uninterrupted run's {want}, max relative difference {rel!r} "
          f"(limit {TRAIN_RESUME_TOL})", flush=True)
    check(len(got) == len(want) and rel <= TRAIN_RESUME_TOL,
          "5i: the resumed losses differ from the uninterrupted run's")
    del resumed
    shutil.rmtree(ckpt, ignore_errors=True)
    free_card()
    result.update(resume_losses=got, resume_rel=rel)
    return result


def flash_bwd_rows(q, k, v, do, band, win: int) -> dict:
    """``flash_bwd_times``'s rows for one batch of gemma3-1b's heads: the
    three backward kernels (and the whole backward beside SDPA's) of a
    global layer and of a ``win``-window one (``band`` its dense mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention import (
        _flash_cuda, bwd_delta, bwd_delta_plain, flash_attention_bwd,
        flash_attention_bwd_plain)
    out = {}
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    for label, window in (("global", None), ("local", win)):
        tag = label if b == 1 else f"{label}, B {b}"
        kw = dict(causal=True, window=window, logit_softcap=None)
        with torch.no_grad():
            o, lse = _flash_cuda(q, k, v, scale=None, with_lse=True, **kw)
        delta = bwd_delta(o, do)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        pairs = live_pairs(s, s, True, window) * b
        mask = (1, -1 if window is None else window, 0.0, d ** -0.5)
        shape = (b, hq, hkv, s, s, d, 1)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr())
        qbytes, kbytes = 2 * q.numel(), 2 * k.numel()

        def plain_bwd(kw=kw, o=o, lse=lse):
            return flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        # the pre-pass's multiply-adds run on the CUDA cores in float32
        pre = {f"flash_attention_bwd_pre ({tag})": (
            lambda o=o: bwd_delta(o, do),
            lambda o=o: bwd_delta_plain(o, do), None,
            (2 * qbytes + 4 * b * hq * s, 2 * q.numel()),
            "flash_bwd_pre_kernel")}
        rows = {
            f"flash_attention_bwd_dkdv ({tag})": (
                lambda common=common, mask=mask: cuda.launch(
                    "flash_attention_bwd_dkdv", *common, dk.data_ptr(),
                    dv.data_ptr(), *shape, *mask),
                plain_bwd, None,
                (2 * qbytes + 8 * b * hq * s + 4 * kbytes,
                 8 * hq * d * pairs), ("flash_bwd_dkdv",)),
            f"flash_attention_bwd_dq ({tag})": (
                lambda common=common, mask=mask: cuda.launch(
                    "flash_attention_bwd_dq", *common, dq.data_ptr(),
                    *shape, *mask),
                plain_bwd, None,
                (3 * qbytes + 8 * b * hq * s + 2 * kbytes,
                 6 * hq * d * pairs), ("flash_bwd_dq",)),
        }
        timed = time_rows(pre, SCALAR_OPS_PER_S, hold=False)
        timed.update(time_rows(rows, TENSOR_OPS_PER_S, hold=False))
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"backward ({tag}): not finite")
        total = sum(r["ms"] for r in timed.values())
        bound, _by = least_ms(4 * qbytes + 4 * kbytes, 10 * hq * d * pairs,
                              TENSOR_OPS_PER_S)
        wrapper = (time_ms(lambda kw=kw, o=o, lse=lse: flash_attention_bwd(
            q, k, v, o, lse, do, **kw), 5) + time_ms(
            lambda kw=kw, o=o, lse=lse: flash_attention_bwd(
                q, k, v, o, lse, do, **kw), 5)) / 2
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        sd = F.scaled_dot_product_attention(
            *leaves, enable_gqa=True,
            **(dict(is_causal=True) if window is None
               else dict(attn_mask=band)))

        def lib(sd=sd, leaves=leaves):
            return torch.autograd.grad(sd, leaves, do, retain_graph=True)
        library = (time_ms(lib, 5) + time_ms(lib, 5)) / 2
        print(f"   flash backward ({tag}): three kernels {total!r} ms "
              f"(device), wrapper {wrapper!r} ms, bound {bound!r} ms "
              f"({10 * hq * d * pairs} operations at 989 TFLOP/s), "
              f"{total / bound!r} x bound; scaled_dot_product_attention "
              f"backward {library!r} ms", flush=True)
        del leaves, sd
        for name, row in timed.items():
            out[name] = row
        out[f"backward ({tag})"] = {
            "ms": total, "wrapper_ms": wrapper, "bound_ms": bound,
            "x_bound": total / bound, "library_ms": library,
            "ops": 10 * hq * d * pairs}
    return out


def flash_bwd_times() -> dict:
    """Phase 6: the backward kernels at gemma3-1b's training shapes
    (bfloat16, Hq 4, Hkv 1, S = TRAIN_SEQ, D 256; a global layer and a
    local one of window 512), at B 1 and at phase 5i's launch size, a
    microbatch of TRAIN_BATCH // TRAIN_MICRO sequences (rows "(global, B
    2)" ...), each launch held by the profiler's device time, beside its
    plain version (the pre-pass: ``bwd_delta_plain``; dk/dv and dq:
    ``flash_attention_bwd_plain``, which computes
    all three) and its bound: the pre-pass moves o and dO once and writes
    D (bytes); dk/dv does 8 Hq D operations per live (query, key) pair
    (the scores, dP, dv, dk) and dq 6 Hq D (the scores, dP, dq), over the
    bfloat16 tensor-core rate.  The whole backward (the three launches'
    device times summed) beside 10 Hq D operations per live pair (2.5 x
    the forward's 4) and one ``scaled_dot_product_attention`` backward
    (``torch.autograd.grad`` of its output, causal; the local layer with a
    dense boolean band mask), timed for the record only.  The forward
    kernel with and without ``lse`` in turns, at S = TRAIN_SEQ and at
    LM_SEQ; at TRAIN_SEQ beside its bound (4 Hq D operations per live
    pair) and one ``scaled_dot_product_attention`` forward (the local
    layer with the dense band mask)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import _flash_cuda
    hq, hkv, s, d, win = 4, 1, TRAIN_SEQ, 256, 512
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 31)
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - win)
    out = {}
    for b in (1, TRAIN_BATCH // TRAIN_MICRO):
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen)
                       .to(torch.bfloat16) for shape in ((b, hq, s, d),
                                                         (b, hkv, s, d),
                                                         (b, hkv, s, d),
                                                         (b, hq, s, d)))
        if b == 1:
            fwd_qkv = (q, k, v)
        out.update(flash_bwd_rows(q, k, v, do, band, win))
    q, k, v = fwd_qkv
    b = 1
    # the forward with and without lse, in turns
    for seq in (TRAIN_SEQ, LM_SEQ):
        x = [t[:, :, :seq] if seq <= s else None for t in (q, k, v)]
        if seq > s:
            x = [torch.randn((b, h, seq, d), device="cuda", generator=gen)
                 .to(torch.bfloat16) for h in (hq, hkv, hkv)]
        for window in (None, win):
            def fwd(with_lse, x=x, window=window):
                return lambda: _flash_cuda(*x, causal=True, window=window,
                                           logit_softcap=None, scale=None,
                                           with_lse=with_lse)
            n1 = kernel_device_ms(fwd(False), 20, None, "flash_wgmma_kernel")
            l1 = kernel_device_ms(fwd(True), 20, None, "flash_wgmma_kernel")
            l2 = kernel_device_ms(fwd(True), 20, None, "flash_wgmma_kernel")
            n2 = kernel_device_ms(fwd(False), 20, None, "flash_wgmma_kernel")
            print(f"   flash forward S={seq} window {window}: without lse "
                  f"{n1!r} / {n2!r} ms, with lse {l1!r} / {l2!r} ms "
                  f"(device)", flush=True)
            row = {"no_lse_ms": [n1, n2], "lse_ms": [l1, l2]}
            if seq == TRAIN_SEQ:
                ops = 4 * hq * d * live_pairs(seq, seq, True, window)
                bound, _by = least_ms(0, ops, TENSOR_OPS_PER_S)
                kw = (dict(is_causal=True) if window is None
                      else dict(attn_mask=band))
                with torch.no_grad():
                    library = time_ms(
                        lambda x=x, kw=kw: F.scaled_dot_product_attention(
                            *x, enable_gqa=True, **kw), 20)
                print(f"   flash forward S={seq} window {window}: bound "
                      f"{bound!r} ms ({ops} operations at 989 TFLOP/s), "
                      f"scaled_dot_product_attention {library!r} ms",
                      flush=True)
                row.update(bound_ms=bound, library_ms=library)
            out[f"forward S={seq} window {window}"] = row
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import cuda  # fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = smi
    t_start = time.perf_counter()

    with phase("build"):
        took = cuda.build_all()
        for name, secs in took.items():
            print(f"   nvcc {name}: {secs:.2f} s", flush=True)
        logs = set()
        for name in cuda.KERNELS:
            log = cuda._lib_path(name).with_suffix(".log")
            if log.exists() and log not in logs:
                logs.add(log)
                summary = ptxas_summary(log.read_text())
                for line in summary:
                    print(f"   {name}: {line}", flush=True)
                if name in WGMMA_KERNELS:
                    for line in wgmma_report(name, summary):
                        print(f"   ptxas, no spills: {line}", flush=True)
            cuda.kernel_fn(name)

    # 5j (c)'s dry-run runs on the host beside the card's phases
    dry_dir = root / "build" / "dryrun_torch"
    dry = start_dryrun(dry_dir)
    try:
        return run_phases(card, cuda, t_start, dry, dry_dir)
    finally:
        stop_dryrun(dry)


def run_phases(card: str, cuda, t_start: float, dry: list,
               dry_dir: Path) -> int:
    import torch
    with phase("kernels vs plain versions"):
        bench = KernelBench("cuda")
        bench.run()
        abench = AdaptiveKernelBench("cuda")
        abench.run()
        sbench = StreamingKernelBench("cuda")
        sbench.run()
        fbench = FlashKernelBench("cuda")
        fbench.run()
        bwbench = FlashBwdBench()
        bwbench.run()
        max_err = {**bench.max_err, **abench.max_err, **sbench.max_err,
                   **fbench.max_err, **bwbench.max_err, **scan_vs_plain()}
        torch.cuda.synchronize()

    with phase("slice parity cuda vs cpu"):
        for slots in (0, 64):
            slice_parity(100_000, slots)
        adaptive_parity("adaptive stream", n_buckets=1 << 14,
                        n_members=48 * 1024, n_benign=200_000)
        adaptive_parity("adaptive stream at load 0.95", n_buckets=1 << 12,
                        n_members=12 * 1024, n_benign=100_000,
                        late=int(0.95 * (1 << 14)) - 12 * 1024)
        ring_parity()
        prefix_index_parity()
        for adaptive in (False, True):
            batcher_parity(adaptive)
        slo_parity()
        sharded_parity()
        continuous_batcher_parity(*lm_parity())
        moe_parity()
        arch_parity()
        train_parity()

    # Each path runs with the counts set to 0 just before it and read just
    # after; its kernels' "launches" come from that run.
    launches, plain = {}, {}
    with phase("main path at full size"):
        ocf, resident, counts, plain["main"], main_times = main_path(
            "cuda", card)
        launches.update({k: counts.get(k, 0) for k in STATIC_KERNELS})

    with phase("adaptive path at full size"):
        m, remaining, counts, plain["adaptive"], adaptive_stats = \
            adaptive_path(card)
        launches.update({k: counts.get(k, 0) for k in ADAPTIVE_KERNELS})

    with phase("streaming path at full size"):
        ring, present, counts, plain["streaming"], _stats = streaming_path(
            card)
        launches.update({k: counts.get(k, 0) for k in STREAMING_KERNELS})
        check(counts.get("insert_bulk", 0) > 0,
              "insert_bulk was never launched on the streaming path")

    with phase("filter-op waves at full size"):
        waves = filter_wave_path(card)
        launches.update({k: waves["launches"].get(k, 0)
                         for k in cuda.TM_KERNELS})
        plain["waves"] = waves["plain"]

    with phase("SLO scenarios at node size"):
        slo = slo_node_path(card)
        plain["slo"] = slo["plain"]

    with phase("sharded node set at node size"):
        sharded = sharded_node_path(card)
        launches.update({k: sharded["launches"].get(k, 0)
                         for k in SCAN_KERNELS})
        plain["sharded"] = sharded["plain"]

    with phase("LM serving path at full size"):
        counts, plain["lm"], lm_out = lm_path(card)
        launches.update({k: counts.get(k, 0) for k in LM_KERNELS})
        counts, plain["lm_batcher"], _lmb = lm_batcher_path(card)
        missing = [k for k in ("fingerprint_hash", "probe", "insert_bulk")
                   if not counts.get(k)]
        check(not missing, f"(d) the prefix index never launched {missing}")

    free_card()
    with phase("training path at full width"):
        trained = train_path(card)
        launches.update({k: trained["launches"].get(k, 0)
                         for k in TRAIN_KERNELS})

    for name in cuda.KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name} was never launched on its path")
    for path, calls in plain.items():
        check(sum(calls.values()) == 0,
              f"plain versions ran on the {path} path: {calls}")

    with phase("kernel times"):
        perf = kernel_times(ocf, resident)
        perf.update(adaptive_kernel_times(m, remaining))
        path = probe_adaptive_path_times(m, remaining,
                                         adaptive_stats.pop("benign"))
        perf["probe_adaptive"].update(
            path_keys=path["benign"]["keys"], path_ms=path["benign"]["ms"],
            path_bound_ms=path["benign"]["bound_ms"])
        perf["probe_adaptive_tm"].update(
            path_keys=path["benign"]["keys"],
            path_ms=path["benign"]["tm_ms"],
            path_bound_ms=path["benign"]["bound_ms"])
        perf.update(streaming_kernel_times(ring, present))
        perf.update(scan_kernel_times(sharded))
        del sharded
        gc.collect()
        torch.cuda.empty_cache()
        flash = flash_kernel_times()
        perf["flash_attention"] = flash["global"]
        perf["flash_attention"]["mla"] = mla_flash_times()
        perf["flash_attention"]["path_shapes"] = arch_flash_times()
        bwd = flash_bwd_times()
        for name in TRAIN_KERNELS:
            perf[name] = dict(bwd[f"{name} (global)"])
            perf[name]["training_shapes"] = {
                label: {**bwd[f"{name} ({label})"],
                        "backward": bwd[f"backward ({label})"]}
                for label in ("global", "local", "global, B 2",
                              "local, B 2")}
            perf[name]["training_shapes"]["launches_per_step"] = \
                trained["per_step"][name]
        perf["flash_attention"]["forward_lse"] = {
            k: v for k, v in bwd.items() if k.startswith("forward")}
        # The launch floor: a one-element add's device time, beside the
        # kernels whose launches take about that long.
        one = torch.zeros(1, device="cuda")
        floor = kernel_device_ms(lambda: one.add_(1), 20, None,
                                 "elementwise_kernel")
        check(floor is not None, "the profiler trace holds no device time "
                                 "for a one-element add")
        print(f"   launch floor (one-element torch add): {floor!r} ms "
              f"(device)", flush=True)
        sized = probe_path_times(slo["node"], floor)
        top = max(PROBE_PATH_SIZES)
        for name, key in (("probe", (top, "the arm's stash")),
                          ("probe_tm", (top, "the arm's stash")),
                          ("fingerprint_hash",
                           (max(FINGERPRINT_PATH_SIZES), ""))):
            row = sized[(name, *key)]
            perf[name].update(path_keys=key[0], path_ms=row["flushed_ms"],
                              path_bound_ms=row["bound_ms"])
        for name in ("fingerprint_hash", "probe", "fingerprint_hash_family",
                     "probe_adaptive", "probe_multi"):
            print(f"   {name}: {perf[name]['ms']!r} ms (device), "
                  f"{perf[name]['ms'] / floor!r} x the launch floor",
                  flush=True)
        print(f"   probe_adaptive without a stash: "
              f"{perf['probe_adaptive']['no_stash_ms']!r} ms (device), "
              f"{perf['probe_adaptive']['no_stash_ms'] / floor!r} x the "
              f"launch floor", flush=True)
        # The telemetry instantiations beside their flag-off kernels.
        for name, off in cuda.TM_KERNELS.items():
            print(f"   {name}: {perf[name]['ms']!r} ms (device) against "
                  f"{off}'s {perf[off]['ms']!r} ms: "
                  f"{(perf[name]['ms'] / perf[off]['ms'] - 1) * 100!r} % "
                  f"more", flush=True)
        # Phase 4's wall time against its kernels' share: launches there
        # times the device time of one 4096-key launch here.
        for name, op in (("insert_bulk", "insert_s"),
                         ("delete_bulk", "delete_s")):
            k_s = launches[name] * perf[name]["ms"] / 1e3
            print(f"   main path {name}: {main_times[op]!r} s wall, "
                  f"{launches[name]} launches x {perf[name]['ms']!r} ms = "
                  f"{k_s!r} s in the kernel (share "
                  f"{k_s / main_times[op]!r})", flush=True)

    # Phase 5g needs the card's memory: nothing of the earlier phases stays.
    slo_rows = slo["rows"]
    del ocf, resident, m, remaining, ring, present, waves, slo, one
    free_card()
    with phase("MoE + MLA serving at full size"):
        counts, plain["moe"], moe = moe_path(card)
        perf["flash_attention"]["mla"]["launches_per_forward"] = \
            moe["forward_launches"]
        check(sum(plain["moe"].values()) == 0,
              f"plain versions ran on the MoE path: {plain['moe']}")

    with phase("5j (a) ContinuousBatcher over MLA caches at full width"):
        batcher_path(card, BATCHER_ARCHS["mla"])

    free_card()
    with phase("SSM, RG-LRU, cross-attention and prefix models at full "
               "width"):
        counts, plain["arch"], arch = arch_path(card)
        for label, n in (("musicgen", "musicgen-large"),
                         ("llava", "llava-next-mistral-7b"),
                         ("nemotron", "nemotron-4-15b"),
                         ("recurrentgemma", "recurrentgemma-2b")):
            shapes = perf["flash_attention"]["path_shapes"]
            for key in shapes:
                if key.startswith(label):
                    shapes[key]["launches_per_forward"] = \
                        arch["forward"][n]["flash_launches"]
        check(sum(plain["arch"].values()) == 0,
              f"plain versions ran on the 5h path: {plain['arch']}")

    with phase("5j (a) ContinuousBatcher over recurrent caches at full "
               "width"):
        batcher_path(card, BATCHER_ARCHS["recurrent"])

    with phase("5j (b) the five filter examples on the card"):
        run_examples(card)

    with phase("5j (c) the dry-run on the host, model-FLOPs shares"):
        dryrun_path(card, dry, dry_dir, lm_out, trained)

    rows = []
    for name, (source, replaces, held_by) in KERNEL_ROWS.items():
        t = perf[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": t["ms"],
                     "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "held_by": held_by,
                     "library_ms": t.get("library_ms"),
                     **{k: t[k] for k in ("path_keys", "path_ms",
                                          "path_bound_ms", "lanes",
                                          "us_per_lane", "schedule",
                                          "key_lanes", "key_ms",
                                          "key_us_per_lane", "key_plain_ms",
                                          "key_bound_ms", "key_schedule",
                                          "split_lanes", "split_ms",
                                          "split_us_per_lane",
                                          "split_plain_ms", "split_bound_ms",
                                          "split_schedule", "groups",
                                          "group_ms", "mla", "path_shapes",
                                          "training_shapes", "forward_lse")
                        if k in t}})
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"slo": slo_rows}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
