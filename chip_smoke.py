#!/usr/bin/env python3
"""Drive the PyTorch port of the IMAGine serving stack on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh`` runs ``env``, ``build`` and phase
``mesh`` alone, ``--launch`` phase ``launch`` alone; ``--mesh-rank R
--mesh-shape DxM --mesh-dir DIR`` is one of phase ``mesh``'s rank
processes, which it starts itself.)

It builds the hand-written CUDA kernels of ``src/repro_torch/csrc`` and runs
these phases, each printing JSON lines; any failure raises and the script
exits non-zero:

1. ``env``      torch / CUDA versions, the card, its power limit.
2. ``build``    nvcc of every kernel source, in parallel; build seconds.
3. ``parity``   each kernel against its plain PyTorch version on card
                tensors at its path's shapes, with the tolerance; the two
                GEMVs through each of their routes (``decode`` M <= 8, at
                M 1 / 2 / 4 / 8, run twice for the same bits; ``rows``
                float32 x, ``tensor_core`` bfloat16 x at larger M), the
                last at ragged prefill M (100, 8192), K and N (300, 1983,
                3352); the bit-plane GEMV's expert-grouped launch (stacked
                MoE experts) through its three routes (``grouped_decode``
                at 8 rows an expert, run twice for the same bits;
                ``grouped_tensor_core`` / ``grouped_rows`` at 64) at
                llama4-scout's and qwen3-moe's expert shapes, with routed
                counts, empty experts, every row in one expert and every
                expert at the bound; paged decode attention's splits over
                a 4096-key table (G 1-12, Dh 64-128, pages 16 / 32, run
                twice); flash attention (D up to 256, padded outside 32 /
                64 / 128 / 256; zamba2-7b's shared block, D 112 at G 1;
                a ``(1, 2)`` rank of ``mesh_prefill``, Hq 8, Hkv 1)
                and the chunked prefill through both of their routes
                (``tensor_core`` bfloat16, ``cuda_core`` float32), the
                prefill's tensor-core route at D 192 and 256 too; past
                D 256 flash on its ``wide`` route and the prefill on its
                ``cuda_core`` route (flash at D 320 and 512 in bfloat16
                and float32, windowed; the prefill at D 320 with bf16
                queries over bf16 and int8 pools); the
                bit-plane GEMV at the vlm, audio and hybrid configs'
                linears (zamba2's in_proj / out_proj, llava's w_down,
                musicgen's lm_head) through every route; the
                serving benchmark's linears and heads (mistral-large-123b,
                starcoder2-15b) on the decode route at M 1 and 8, bf16,
                run twice, where pieces cross tile edges; the SSD
                scan at 1, 16 and 32 chunks, N 64 and 128, bfloat16 and
                float32 inputs, and chunks over 256 steps that the kernels
                cut, with a shorter last chunk (``SSD_CASES``, every call
                twice: the same bits);
   ``time``     kernel, plain-version and PyTorch-library times at those
                shapes, with the bytes and operations each call needs and
                the least time the card could take for them, and the GEMV
                route each row took (decode rows at M = 8, 2 and 4: the
                paged, ``long`` and ``ssm`` decode steps); with the
                bit-plane GEMV at 8 (radix 1, 2), 4 and 2 bits beside the
                int8 bit-parallel baseline, the card's version of the
                paper's bit-serial against bit-parallel comparison; the
                grouped launch at the MoE experts' shapes, a decode step
                (8 lanes routed: the bound counts the touched experts'
                codes) and a chunk (64 rows an expert), against
                ``torch.bmm`` on the touched experts' bf16 weights.  The
                rows of the kernels that replaced an earlier design carry
                its time (``earlier_ms``, ``EARLIER_MS``).
4. ``main``     paged serving: ``ServeEngine`` on full-width qwen2.5-3b (36
                layers, bf16, ``EngineConfig(weight_bits=4, kv_bits=8)``):
                16 seeded prompts of 33-300 tokens, 32 new tokens each,
                every decode step and prefill chunk a replayed CUDA graph
                (the seconds of their capture reported apart); then
                ``main_profile``: one ``torch.profiler`` session over four
                decode-only steps (replays) of 8 more prompts, the device
                kernel ms per step by kernel and the device busy share,
                and unprofiled the decode graph's device time over the
                step's host time (``replay_share``); then the 16
                prompts once more with ``cuda_graphs=False``
                (``main_eager``): identical greedy tokens, both runs' tok/s
                and step ms side by side (``main_graphs_vs_eager``).
   ``prefix``   on ``main``'s configuration and params: 24 prompts of one
                seeded 200-token system prompt and a 16-96-token suffix
                each, request 0 served alone until its prefill completes,
                then the other 23; ``prefix_cold`` without the prefix
                cache, ``prefix_hot`` with it (identical greedy tokens; 23
                hits, 1 miss, 4,600 hit tokens and 23 copy-on-write forks;
                4,600 fewer prefill tokens computed), ``prefix_evict`` the
                hot traffic in a 97-page pool (cached pages evicted,
                identical tokens), each auditing itself after every phase
                of every step (``ServeConfig(audit=2)``) and capturing its
                two step graphs once; ``budget``: ``main``'s prompts under
                ``sched="budget"`` (40 tokens a step), priorities
                alternating interactive and batch: ``main``'s tokens, no
                step over the budget; ``frontend``: a ``ServeFrontend``
                over a hot engine on a manual clock, 8 streams of the
                prefix traffic, one cancelled mid-prefill (its pages and
                pins released, audited), one timed out, the others
                streaming ``prefix_hot``'s tokens.  Each run prints tok/s,
                prefill chunks and chunk ms, prompt tok/s, prefill tokens
                computed, TTFT p50 / p99 and peak memory.
   ``obs``      ``main``'s prompts once more on its configuration with
                ``repro_torch.obs`` on (trace, profiler ranges): ``main``'s
                tokens, tok/s beside ``main``'s, the host ms p50 / p99 of
                each step phase (the trace's spans) and of each dispatch
                (the registry), the decode graph's replay ms (CUDA
                events), the sampling ms a decode step, TTFT / TPOT /
                queue wait, the cost ledger's bytes and FLOPs of one
                decode step and one prefill chunk over their mean and p50
                times as shares of 3.35 TB/s and 989 TFLOP/s
                (``decode_hbm_roofline_share_*``, ``prefill_mfu_*``), the
                validated Chrome trace (``chiprun_out/obs_trace.json``)
                and the Prometheus text's length.
   ``chaos``    ``chaos_drill``: ``prefix_hot``'s traffic under a seeded
                ``ChaosInjector`` at every engine site with a retry budget
                of 5: every site fired, retries, no quarantine, wasted
                FLOPs in the ledger, every audit passed, and
                ``prefix_hot``'s tokens, exactly for a request never
                retried or preempted and up to a near tie for one
                recomputed by prefill; ``quarantine``: 8 short prompts
                through ``ServeFrontend``, ``nan_logits`` at its third
                check with no budget: one stream in ``error``, the others
                a clean run's, the victim's pages zero on the card.
   ``snapshot`` the recovery drill on ``main``'s params: ``main``'s 16
                prompts run to a kill point k (requests decoding, lanes
                mid-prefill, requests queued), ``save_snapshot`` to
                ``build/snapshots/``, a fresh engine ``load_snapshot`` s
                and runs to the end; then the first engine, its two graphs
                captured, ``restore`` s in place (no new capture, the pool
                and lane buffers at the same addresses) and runs to the
                end again; the same on ``prefix_hot``'s traffic with the
                cache's tree (hit counters going on from the snapshot's).
                A restore recomputes nothing: ``main``'s / ``prefix_hot``'s
                tokens, exactly or (reported by request) up to a near tie.
                Snapshot bytes, codec, save / load / restore seconds.
   ``mesh``     after ``snapshot``, on ``main``'s params: the kernels at a
                mesh rank's shapes (``mesh_parity``: the bit-plane GEMV at
                the local linears of a (1, 2) rank at M 4 / 8 / 128 / 256,
                4 and 8 bits; paged decode and prefill attention at one
                KV head, G 8); the single-device eager engine on
                ``main``'s first 8 prompts, 16 new tokens; then the same
                traffic on a ``(data, model)`` mesh of ``(1, 2)`` (heads,
                MLP features and vocabulary split over two ranks) and of
                ``(2, 1)`` (lanes and pages over two data shards): two
                rank processes, each ``chip_smoke.py --mesh-rank R
                --mesh-shape DxM --mesh-dir DIR`` (``gloo`` through host
                memory on one card; NCCL, one rank a device, on two or
                more), ``EngineConfig(weight_bits=4, kv_bits=8,
                sharded=True)``, each step a sequence of CUDA graph
                segments cut at its ``gloo`` collectives, which the host
                runs between their replays (75 a step at ``(1, 2)``, one
                at ``(2, 1)``), then the same traffic eagerly: the
                transport, every rank's tokens equal with graphs and
                eager, equal over the ranks and to the single-device
                engine's up to near ties, each rank's launches by route
                equal in both runs (the GEMV's decode and tensor-core
                routes and both attention kernels above 0), tok/s, step
                and chunk ms, host ms in collectives and waiting a step,
                segments a step, capture seconds, peak memory and pool
                shape, graphs beside eager; at ``(1, 2)``,
                ``psum_bits=8`` at layer 0's row-parallel w_down within
                ``n·scale/2`` of the exact sum.  Then, in the same
                spawn, each rank serves the family cells of
                ``MESH_CELLS`` in turn on graph segments at
                ``weight_bits=4``, each held against its single-device
                engine on the same params: paged at ``(1, 2)``, ``main``'s first 8 prompts,
                16 new tokens, ``kv_bits=8``: llava-next (8 of 32
                layers), musicgen (24 of 48), llama4-scout (6 of 48: 8
                of 16 experts a rank), qwen3-moe (4 of 94: 64 of 128),
                and the two MoE
                configs at 2 layers in float32 with float32 pages; slots
                mode, 4 prompts of 8-16 tokens, 8 new, ``kv_bits=0``:
                qwen2.5-3b (6 of 36) and mamba2-130m (24) at both meshes,
                zamba2-7b (6 of 81, 1 site) and gemma3-27b (2 of 62,
                one prompt past the 1024-token window) at ``(1, 2)``.
                The bf16 MoE ranks replay one device's routing, and each
                choice of their own that differs from it must be at a
                router near tie (``replay_routes``); a replay runs no
                Python, so these two cells run eagerly, on one device
                and on the ranks (``MESH_REPLAY_EAGER``).  ``mesh_parity``
                also holds every linear of each cell's rank (its untied
                head included), the grouped launch at a rank's experts
                and paged attention at each paged cell's rank heads,
                all at the shapes the port's placement gives a rank
                (``mesh_shapes``).  The checks and the
                ``mesh_families`` line: ``mesh_family_checks``.  Then,
                in the same spawn, the cells of PR 27, each held against
                one device (``mesh_slice_checks``): ``mesh_snapshot``
                (``main``'s first 8 prompts on 4 lanes killed at a
                restart point, saved by every rank; restored in place
                into the rank engines, their graphs captured (no new
                capture, every address the segments replay unchanged),
                and loaded and restored into fresh rank engines: the
                uninterrupted run's tokens;
                the same snapshot into the single-device engine: its
                tokens up to near ties; save / load / restore s),
                ``mesh_chaos`` at ``(1, 2)`` (``MESH_CHAOS``'s schedule
                fires ``page_grant``, ``step_fault``, ``nan_logits`` and
                ``preempt_storm``: every rank's log, quarantines, retries
                and finish reasons one device's, tokens up to near ties),
                ``mesh_prefill`` (``long``'s qwen2.5-3b 2 x 4096 at both
                meshes, ``ssm``'s mamba2-130m 4 x 4096 at ``(1, 2)``: a
                one-shot ``prefill(mesh=)``, flash at a rank's heads and
                the SSD scan once a layer on every rank, last logits
                within ``long_whole``'s 0.125; seconds, collective ms)
                and ``mesh_train`` (qwen2.5-3b at 4 of 36 layers in
                float32, 1 x 1024 tokens a data shard, 3 AdamW steps:
                losses, grad norms and the change of every rank's params
                against one device's within ``MESH_TRAIN_TOL``, no kernel
                launched; step ms,
                collective ms, peak memory).  A rank that fails or
                outlives ``MESH_TIMEOUT`` fails the phase.
   ``dense``    starcoder2-15b (20 of 40 layers), gemma3-27b (16 of 62 layers, window
                1024 on 5 of 6 layers, 8 prompts of 1,100-1,900 tokens,
                max_len 2048) and mistral-large-123b cut to 8 of its 88
                layers, at published widths, served paged at
                ``weight_bits=4, kv_bits=8``, 8 lanes, page 16, chunk 32:
                tok/s, step and chunk ms, peak memory, launches by route,
                the cost ledger's decode bytes over the step as a share of
                3.35 TB/s; graphs against eager (identical tokens); and
                ``whole``'s check at 2 layers (gemma3: one local, one
                global layer, prompts past the window).
   ``moe``      after ``dense`` has freed its params: llama4-scout-17b-a16e
                (12 of 48 layers, full width, 16 experts top-1 and a shared
                expert) and qwen3-moe-235b-a22b cut to 8 of 94 layers
                (128 experts top-8), ``main``'s setup and traffic, the
                expert linears on the grouped launch: tok/s, step and
                chunk ms, init seconds, peak memory, launches by route
                (the grouped routes above 0, checked step by step), the
                ledger's decode bytes share (every expert priced, as the
                JAX package's ledger prices them) and the routed one (the
                experts the steps touched); ``moe_*_profile``: four
                decode steps and two chunks by kernel, as
                ``main_profile``; graphs against eager (identical
                tokens); ``whole``'s check at 2 layers in
                float32 with float32 pages (a router near-tie rerouted by
                a bf16 rounding is no kernel fault).
   ``families`` after ``moe``: llava-next-mistral-7b (16 of 32 layers)
                and musicgen-medium (24 of 48 layers, 4 codebooks, each
                prompt id
                broadcast over them) served paged with ``main``'s setup
                and traffic: tok/s, step and chunk ms, init seconds, peak
                memory, launches by route, the ledger's decode bytes
                share; graphs against eager (identical tokens); at 2
                layers against the plain backends; llava's full-sequence
                path (2 prompts of 2880 seeded image positions and 1216
                tokens: flash attention, then 16 decode steps) and at 2
                layers against the plain path and ``forward``; zamba2-7b
                (42 of 81 layers, one shared attention block applied at 7
                sites) in slots mode (8 slots, max_len 1024, 8 prompts of
                17-64 tokens, 16 new each), graphs against eager at 12
                layers (two sites), its full-sequence path (2 x 4096
                tokens: the SSD scan in every layer, flash attention at
                each site, 16 decode steps) and at 6 layers (one site)
                against the plain path and ``forward``; a
                ``families_launches`` line with each path's launches by
                kernel and route.
5. ``second``   the same at ``weight_bits=8, kv_bits=0`` (bf16 KV pages),
                cut to 4 layers: the full-precision attention variants.
6. ``whole``    at 2 layers, full width: the kernel engine against an engine
                on the plain backends (``reference`` GEMV, ``gather``
                attention); same greedy tokens, first-step logits within
                tolerance.
7. ``long``     the full-sequence path: full-width qwen2.5-3b
                (``weight_bits=4``, full-precision slots cache),
                ``init_cache`` for 2 x 4160, one-shot ``prefill`` of two
                seeded 4096-token prompts (flash attention), 32 greedy
                ``decode_step`` s, replays of one CUDA graph.
8. ``ssm``      the same for full-width mamba2-130m (24 layers,
                ``weight_bits=4``): four 4096-token prompts (SSD scan),
                32 decode steps.
9. ``long_whole`` at 2 layers, full width, both models: the kernel path
                (decode steps as graph replays) against the same path
                eager (identical greedy tokens) and against the plain path
                (same greedy tokens, first-step logits within tolerance),
                and ``forward`` over prompt and continuation against
                ``prefill`` + ``decode_step`` logits (teacher forcing).
   ``slots``    slots-mode serving: full-width mamba2-130m
                (``weight_bits=4``), 8 slots, max_len 1024, 16 seeded
                prompts of 33-300 tokens entering by sequential decode, 32
                new tokens each, every step a replayed graph of the
                full-sequence ``decode_step``; then graph against eager
                (identical greedy tokens) at 2 layers, and for qwen2.5-3b
                (``kv_bits=0``) cut to 4 layers.
   ``train``    training: full-width qwen2.5-3b (36 layers, bf16, tied
                151,936 vocabulary) through ``make_train_step`` (AdamW,
                ``remat="block"``, two microbatches, the loss through
                ``chunked_ce`` on the plain ``gather`` mixers, no kernel),
                5 steps of 2 x 1024 tokens from ``DataPipeline``'s memmap
                source over a seeded Zipfian token file: each step's
                loss, grad norm, lr and ms, peak memory, the loss finite
                and lower at the last step than at the first; at 2 layers
                in float32, one step on the card against the same step
                on the CPU (loss within rtol 1e-4, grad norm 1e-3), and
                the restart drill (a ``Trainer`` checkpointing every 2
                steps, a node failure at step 3: the uninterrupted run's
                losses within 1e-5).
   ``layouts``  the decode-only slots-cache layouts, eager and greedy from
                empty caches at ``weight_bits=4``: qwen2.5-3b (9 of 36
                layers, 8 lanes, 64 steps) unstacked against stacked (identical
                tokens), int8 stacked against unstacked (logits within
                1e-3) and against full precision (near ties only);
                gemma3-27b cut to 6 layers (5 local, 1 global) in float32,
                2 lanes, 1,100 steps past its 1,024 window: the split
                local/global cache against the uniform one (logits within
                2e-3); zamba2-7b (13 of 81 layers) unstacked against
                stacked (identical tokens).
   ``launch``   the cells of ``repro_torch.launch.steps`` on a
                ``make_host_mesh()`` ``(1, 1)`` (``LAUNCH_CELLS``: qwen2.5-3b
                ``prefill_cell`` 2 x 4096, ``chunked_prefill_cell`` 8 lanes
                x 32 over 1,024-token tables, ``paged_serve_cell`` and
                ``serve_cell`` 8 x 1,024, ``train_cell`` 2 microbatches of
                1 x 1,024 with remat, and mamba2-130m's ``prefill_cell`` 4
                x 4096), each one warm-up and three timed calls (p50 ms),
                then counted under the op counter on the card and on
                ``meta`` (equal, to the unit), its kernel launches equal
                to its priced calls by route, its bound
                (``roofline.roofline_report`` on the data sheet's rates)
                no more than 1.05x its time, its argument bytes on the
                card within 2% of the count's; then the dry records of
                ``LAUNCH_DRY`` (``launch.dryrun.run_cell`` on a rank of a
                ``(16, 16)`` mesh, one of ``(2, 16, 16)``), counted on the
                host's CPU in a background process started after
                ``build``: their three terms, dominant term, memory and
                ``count_s``.
10. ``engine``   the paper's GEMV engine path: ``repro_torch.paper_demo``
                at dim 96 on the card, then at d = 2048 (qwen2.5-3b's wq)
                and d = 1983 (the largest 8-bit GEMV the U55 holds) the
                cycle-counted tile-controller model, the bit-plane GEMV at
                radix 1 and 2 and the int8 bit-parallel kernel on seeded
                integer weights and activations: all four must equal
                ``w @ x`` exactly.
11. ``kernels`` one line: every kernel, its launches on its path (paged
                serving for the first three, ``long`` and ``ssm`` for flash
                attention and the SSD scan, ``engine`` for the int8
                baseline), its error against the plain version and its
                times; for the two GEMVs a decode record (M = 8) and
                ``prefill`` records (M = 8192 and 256, w_gate/w_up) of the
                tensor-core route, with that route's launches on the same
                paths (``long`` and ``main`` prefill; ``engine``, which
                runs the int8 baseline at M = 1 only, for ``int8_matvec``);
                ``bitplane_gemv_grouped``, the grouped launch, with its
                launches by route in ``moe``'s llama4-scout run and its
                timed rows (``grouped``);
                for every kernel with routes its path's launches by route
                (``routes``) and the route its timed record took.

``main``, ``long`` and ``ssm`` check that the GEMV took its tensor-core
route in every prefill and its decode route in every decode step
(``main`` and ``second`` step by step, through ``ServeEngine.step``,
counting each graph replay as its capture's launches; ``slots`` that
every step launched the decode route once a GEMV for each prompt token
it admitted and for its decode step, and nothing else);
``main`` and ``second`` that every prefill chunk launched the chunked
prefill's tensor-core route once a layer, ``long`` that its prefill
launched flash attention's tensor-core route once a layer and its
CUDA-core route never.

The card's ``nvidia-smi`` name and power limit line and the ``kernels``
line come before the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
with an error and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): the bounds below are stated against
# these, with the card's power limit printed beside them.
PEAK_HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
SEED = 0
DEVICE = "cuda"
CARD = None    # the card's nvidia-smi name and power limit, set by ``env``

GEMV_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
GEMV_NAMES = {(2048, 2048): "wq/wo", (2048, 256): "wk/wv",
              (2048, 11008): "w_gate/w_up", (11008, 2048): "w_down",
              (768, 3352): "in_proj", (1536, 768): "out_proj"}
# mamba2-130m's linears (K, N): in_proj to [z, x, B, C, dt], out_proj
SSM_GEMV_SHAPES = [(768, 3352), (1536, 768)]
# the vlm, audio and hybrid configs' linears (K, N): zamba2-7b's in_proj
# (N ragged: 2 x 7168 + 2 x 64 + 112) and out_proj, llava-next's w_down,
# musicgen-medium's lm_head (2048 x 4 codebooks)
FAMILY_GEMV_SHAPES = [(3584, 14576), (7168, 3584), (14336, 4096),
                      (1536, 8192)]
# the serving benchmark's decode GEMVs (K, N), as ``decode_ab.py`` times
# them: mistral-large-123b's wq / wo, wk / wv, w_gate / w_up, w_down and
# head, then starcoder2-15b's; most cut tiles into pieces on the card
SERVING_GEMV_SHAPES = [(12288, 12288), (12288, 1024), (12288, 28672),
                       (28672, 12288), (12288, 32768), (6144, 6144),
                       (6144, 512), (6144, 24576), (24576, 6144),
                       (6144, 49152)]
GEMV_NAMES.update({(3584, 14576): "zamba2 in_proj",
                   (7168, 3584): "zamba2 out_proj",
                   (14336, 4096): "llava w_down",
                   (1536, 8192): "musicgen lm_head"})
KERNELS = {
    "bitplane_gemv": dict(
        route="cuda", source="src/repro_torch/csrc/bitplane_gemv.cu",
        replaces="src/repro/kernels/bitplane_gemv/kernel.py:93"),
    "paged_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:144"),
    "paged_prefill_attention": dict(
        route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:312"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:82"),
    "ssd_scan": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:66"),
    "int8_matvec": dict(
        route="cuda", source="src/repro_torch/csrc/int8_matvec.cu",
        replaces="src/repro/kernels/int8_matvec/kernel.py:40"),
    # the same TPU kernel's function over stacked MoE experts: the
    # expert-grouped launch of its three designs (grouped_* routes)
    "bitplane_gemv_grouped": dict(
        route="cuda", source="src/repro_torch/csrc/bitplane_gemv_grouped.cu",
        replaces="src/repro/kernels/bitplane_gemv/kernel.py:93"),
}
PAGED_KERNELS = ("bitplane_gemv", "paged_decode_attention",
                 "paged_prefill_attention")
# the full-sequence paths' shapes: qwen2.5-3b attention (Hq 16, Hkv 2,
# D 128) over two 4096-token prompts; mamba2-130m SSD (H 24, P 64, N 128,
# chunk 256) over four
FLASH_SHAPE = dict(b=2, s=4096, hq=16, hkv=2, d=128)
SSD_SHAPE = dict(b=4, s=4096, h=24, p=64, n=128)
# the int8 baseline's ragged case: K and N multiples of neither 4 nor 128
INT8_RAGGED = (2001, 1003)
# the GEMVs' tensor-core route at ragged prefill shapes (K, N): K not a
# multiple of the 64-deep K step, N neither 16- nor 8-byte aligned, or only
# 8-byte aligned (mamba2-130m's in_proj)
TC_RAGGED = [(520, 300), (200, 1983), (768, 3352)]
TC_ROWS = (100, 8192)
# the MoE experts' linears (K, N, experts, top_k): llama4-scout-17b-a16e's
# w_gate/w_up and w_down, qwen3-moe-235b-a22b's; the grouped GEMV's
# parity adds a ragged shape.  A decode step routes 8 lanes' tokens, a
# prefill chunk at most 8 rows a lane (the capacity of a 32-token chunk)
GROUPED_SHAPES = [(5120, 8192, 16, 1), (8192, 5120, 16, 1),
                  (4096, 1536, 128, 8), (1536, 4096, 128, 8)]
GROUPED_NAMES = {(5120, 8192): "llama4 w_gate/w_up",
                 (8192, 5120): "llama4 w_down",
                 (4096, 1536): "qwen3 w_gate/w_up",
                 (1536, 4096): "qwen3 w_down"}
GROUPED_BOUNDS = {"decode": 8, "chunk": 64}
# phase moe: (arch, layers or None for all), served with main's setup;
# llama4-scout cut to 12 of 48 layers and qwen3-moe to 8 of 94, to keep
# the whole run inside its time with phase ``launch`` (PERF.md §4)
MOE_CASES = [("llama4-scout-17b-a16e", 12), ("qwen3-moe-235b-a22b", 8)]
# the engine phase's exact GEMVs: qwen2.5-3b's wq (K = N = 2048); the U55's
# largest resident 8-bit square GEMV is added at run time
ENGINE_DIMS = (2048,)
# the SSD scan's parity cases (B, S, H, N, chunk, dtype): the ssm shape at
# 16 and 32 chunks, one chunk, zamba2's state (N 64), float32 inputs, and
# chunks over the kernels' 256 steps (cut to 256: 600 steps end in a chunk
# of 88, 768 in three whole chunks)
SSD_CASES = [(4, 4096, 24, 128, 256, "bfloat16"),
             (4, 4096, 24, 128, 128, "bfloat16"),
             (2, 256, 24, 128, 256, "bfloat16"),
             (2, 4096, 24, 64, 256, "bfloat16"),
             (2, 4096, 24, 128, 256, "float32"),
             (2, 4096, 24, 64, 128, "float32"),
             (1, 256, 8, 128, 256, "float32"),
             (1, 600, 2, 64, 300, "bfloat16"),
             (1, 600, 2, 64, 300, "float32"),
             (2, 768, 3, 128, 384, "bfloat16"),
             (2, 768, 3, 128, 384, "float32")]
# the times of the designs this script's kernels replaced, as it timed
# them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the SSD scan's
# one block a (lane, head) at the ssm shape, and the int8 baseline's
# CUDA-core decode route (M, K, N) with bf16 x
EARLIER_MS = {
    "ssd_scan": 3.141,
    ("int8_matvec", 1, 2048, 2048): 0.0160,
    ("int8_matvec", 1, 2048, 256): 0.0150,
    ("int8_matvec", 1, 2048, 11008): 0.0343,
    ("int8_matvec", 1, 11008, 2048): 0.0725,
    ("int8_matvec", 8, 2048, 2048): 0.0176,
    ("int8_matvec", 8, 2048, 256): 0.0167,
    ("int8_matvec", 8, 2048, 11008): 0.0393,
    ("int8_matvec", 8, 11008, 2048): 0.0820,
}


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


class Phase:
    """Prints a phase's elapsed seconds when it ends; errors propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            emit("elapsed", of=self.name,
                 seconds=time.perf_counter() - self.t0)
        return False


# --------------------------------------------------------------- timing
def timed_ms(fn, arg_sets, torch):
    """Mean device milliseconds of ``fn(*args)`` over ``arg_sets``.

    The argument sets rotate so that the bytes touched across the run
    exceed the L2 cache, as the main path finds its weights and pages cold.
    A sleep kernel holds the stream while the host enqueues every launch,
    so the time is the card's alone and not the host's launch rate.
    """
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for args in arg_sets:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(arg_sets)


def n_copies(bytes_per_call: int) -> int:
    return max(8, min(200, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def bound_ms(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / PEAK_HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_close(name, y, r, rtol, atol, **info):
    """Elementwise ``|y - r| <= atol + rtol * |r|``; returns the largest
    absolute error and the largest share of the bound an element used,
    and raises with the case when the bound does not hold."""
    import torch

    y, r = y.float(), r.float()
    if not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{name}: non-finite output {info}")
    err = (y - r).abs()
    used = err / (atol + rtol * r.abs())
    if bool((used > 1).any()):
        raise AssertionError(
            f"{name}: {int((used > 1).sum())} elements outside rtol={rtol} "
            f"atol={atol}, max error {float(err.max())} {info}")
    return float(err.max()), float(used.max())


# ---------------------------------------------------------- GEMV phase
def gemv_case(torch, dev, gen, bits, k, n, m, dt):
    from repro_torch.core import pack_weights, quantize_symmetric

    w = torch.randn((k, n), generator=gen, device=dev)
    q, scale = quantize_symmetric(w, bits)
    packed = pack_weights(q, bits)
    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
    return packed, scale, x


def gemv_tol(dt, r):
    # float32: the sum order differs from the plain version's; bfloat16
    # output: one rounding of a float32 sum that may differ in its last
    # bits, so one bf16 ulp (at most 2^-7 of the value).  atol scales with
    # the largest output.
    import torch

    big = float(r.float().abs().max())
    if dt == torch.float32:
        return 1e-5, 1e-5 * big
    return 2 ** -7, 1e-5 * big


def route_counts(kernel, counts=None):
    """The launches of ``kernel`` by route since the last reset (or in
    ``counts``, a copy of ``_build.ROUTE_LAUNCHES``)."""
    from repro_torch.kernels import _build

    counts = _build.ROUTE_LAUNCHES if counts is None else counts
    return {k.split("/")[1]: v for k, v in counts.items()
            if k.startswith(kernel + "/")}


def gemv_parity(torch, dev):
    from repro_torch.kernels import _build, _gemv
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv
    from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for bits in (2, 4, 8):
        for radix in (1, 2, 4, 8):
            if bits % radix:
                continue
            # the decode steps' M (8 paged, 2 and 4 full-sequence, 1 the
            # engine) at the main shapes and K, N ragged; and M = 256
            ragged = (INT8_RAGGED[0] + -INT8_RAGGED[0] % (8 // bits),
                      INT8_RAGGED[1])
            for (k, n) in GEMV_SHAPES + [ragged]:
                for m in (1, 2, 4, 8, 256):
                    for dt in (torch.float32, torch.bfloat16):
                        packed, scale, x = gemv_case(torch, dev, gen, bits,
                                                     k, n, m, dt)
                        y = bitplane_gemv(packed, scale, x, bits=bits,
                                          radix=radix, out_dtype=dt)
                        r = bitplane_gemv_ref(packed, scale, x, bits=bits,
                                              radix=radix, out_dtype=dt)
                        rtol, atol = gemv_tol(dt, r)
                        err, used = check_close(
                            "bitplane_gemv", y, r, rtol, atol, bits=bits,
                            radix=radix, m=m, k=k, n=n, dtype=str(dt))
                        if m <= 8 and not torch.equal(y, bitplane_gemv(
                                packed, scale, x, bits=bits, radix=radix,
                                out_dtype=dt)):
                            raise AssertionError(
                                f"bitplane_gemv decode M={m} K={k} N={n}: "
                                "two runs differ")
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
            # ragged prefill M, K and N: the tensor-core route in bf16,
            # the rows route in float32 (at M = 100)
            for (k, n) in TC_RAGGED:
                for m in TC_ROWS:
                    for dt in ((torch.float32, torch.bfloat16) if m < 1000
                               else (torch.bfloat16,)):
                        packed, scale, x = gemv_case(torch, dev, gen, bits,
                                                     k, n, m, dt)
                        y = bitplane_gemv(packed, scale, x, bits=bits,
                                          radix=radix, out_dtype=dt)
                        r = bitplane_gemv_ref(packed, scale, x, bits=bits,
                                              radix=radix, out_dtype=dt)
                        rtol, atol = gemv_tol(dt, r)
                        err, used = check_close(
                            "bitplane_gemv", y, r, rtol, atol, bits=bits,
                            radix=radix, m=m, k=k, n=n, dtype=str(dt))
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
    # the vlm, audio and hybrid configs' linears at 4 bits, through each
    # route at its path's M: decode steps (8, twice for the same bits),
    # float32 rows (100), a paged chunk (256) and zamba2's one-shot prefill
    # (8192, in_proj / out_proj)
    for (k, n) in FAMILY_GEMV_SHAPES:
        for m, dt in ((8, torch.bfloat16), (8, torch.float32),
                      (100, torch.float32), (256, torch.bfloat16),
                      (8192, torch.bfloat16)):
            if m == 8192 and (k, n) not in FAMILY_GEMV_SHAPES[:2]:
                continue
            packed, scale, x = gemv_case(torch, dev, gen, 4, k, n, m, dt)
            y = bitplane_gemv(packed, scale, x, bits=4, out_dtype=dt)
            r = bitplane_gemv_ref(packed, scale, x, bits=4, out_dtype=dt)
            rtol, atol = gemv_tol(dt, r)
            err, used = check_close("bitplane_gemv", y, r, rtol, atol,
                                    bits=4, m=m, k=k, n=n, dtype=str(dt),
                                    linear=GEMV_NAMES[k, n])
            if m <= 8 and not torch.equal(y, bitplane_gemv(
                    packed, scale, x, bits=4, out_dtype=dt)):
                raise AssertionError(f"bitplane_gemv decode {k}x{n}: two "
                                     "runs differ")
            worst, worst_used = max(worst, err), max(worst_used, used)
            n_cases += 1
            del packed, scale, x, y, r
    # the serving benchmark's linears and heads at 4 bits, bf16, on the
    # decode route at M 1 and 8, twice for the same bits; on the card's
    # grid most of them have pieces that cross a tile's edge (a block ends
    # one tile's sum and starts the next's)
    crossing = []
    for (k, n) in SERVING_GEMV_SHAPES:
        grid = _gemv.decode_launch_grid(k, n, 4, 8, torch.bfloat16, dev)
        if len(_gemv.decode_pieces(k, n, grid)) > grid:
            crossing.append(f"{k}x{n}")
        for m in (1, 8):
            packed, scale, x = gemv_case(torch, dev, gen, 4, k, n, m,
                                         torch.bfloat16)
            y = bitplane_gemv(packed, scale, x, bits=4,
                              out_dtype=torch.bfloat16)
            r = bitplane_gemv_ref(packed, scale, x, bits=4,
                                  out_dtype=torch.bfloat16)
            rtol, atol = gemv_tol(torch.bfloat16, r)
            err, used = check_close("bitplane_gemv", y, r, rtol, atol,
                                    bits=4, m=m, k=k, n=n, grid=grid,
                                    dtype="bfloat16")
            if not torch.equal(y, bitplane_gemv(packed, scale, x, bits=4,
                                                out_dtype=torch.bfloat16)):
                raise AssertionError(f"bitplane_gemv decode {k}x{n} M={m}: "
                                     "two runs differ")
            worst, worst_used = max(worst, err), max(worst_used, used)
            n_cases += 1
            del packed, scale, x, y, r
    if not crossing:
        raise AssertionError("bitplane_gemv parity: no serving shape has a "
                             "piece that crosses a tile's edge")
    torch.cuda.synchronize()
    routes = {r: n for r, n in route_counts("bitplane_gemv").items()
              if not r.startswith("grouped_")}
    if not all(routes.values()):
        raise AssertionError(f"bitplane_gemv parity missed a route: {routes}")
    emit("parity", kernel="bitplane_gemv", cases=n_cases,
         sweep="bits{2,4,8} x radix{1,2,4,8} x (M{1,2,4,8,256} x (4 "
               "shapes + K 2001-2004 x N 1003) x {float32,bfloat16} + "
               "M{100,8192} x (K,N){(520,300),(200,1983),(768,3352)} x "
               "bfloat16, float32 at M=100); decode M run twice, the same "
               "bits; 4 bits at the families' linears (zamba2 in_proj "
               "3584x14576, out_proj 7168x3584, llava w_down 14336x4096, "
               "musicgen lm_head 1536x8192) at M 8 (bf16, float32), 100 "
               "(float32), 256 and 8192 (zamba2's, bf16); 4 bits, bf16 at "
               "the serving benchmark's linears and heads (mistral-large-"
               "123b, starcoder2-15b) at M 1 and 8, run twice",
         crossing_tiles=crossing,
         tolerance="float32: rtol 1e-5, atol 1e-5*max|ref|; bfloat16 "
                   "output: rtol 2^-7 (one ulp), atol 1e-5*max|ref|",
         max_abs_err=worst, max_share_of_tol=worst_used, routes=routes)


def gemv_time(torch, dev, m, k, n, bits=4, radix=1, dt=None):
    from repro_torch.roofline import kernel_costs
    from repro_torch.core import unpack_weights
    from repro_torch.kernels import _gemv
    from repro_torch.kernels._gemv import route
    from repro_torch.kernels.bitplane_gemv.kernel import bitplane_gemv_cuda
    from repro_torch.kernels.bitplane_gemv.ref import bitplane_gemv_ref

    dt = dt or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + m + k + n)
    packed, scale, x = gemv_case(torch, dev, gen, bits, k, n, m, dt)
    y = bitplane_gemv_cuda(packed, scale, x, bits=bits, radix=radix,
                           out_dtype=dt)
    r = bitplane_gemv_ref(packed, scale, x, bits=bits, radix=radix,
                          out_dtype=dt)
    rtol, atol = gemv_tol(dt, r)
    err, _ = check_close("bitplane_gemv", y, r, rtol, atol, m=m, k=k, n=n)
    n_bytes, n_ops = kernel_costs.bitplane_gemv(m, k, n, bits,
                                                x.element_size())
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    bms, by = bound_ms(n_bytes, n_ops, dname)
    copies = n_copies(k * n * bits // 8)
    packs = [packed.clone() for _ in range(copies)]
    ms = timed_ms(lambda p: bitplane_gemv_cuda(p, scale, x, bits=bits,
                                               radix=radix, out_dtype=dt),
                  [(p,) for p in packs], torch)
    plain = timed_ms(lambda p: bitplane_gemv_ref(p, scale, x, bits=bits,
                                                 radix=radix, out_dtype=dt),
                     [(p,) for p in packs[:8]], torch)
    del packs
    w_deq = (unpack_weights(packed, bits).float() * scale).to(dt)
    lib_copies = [w_deq.clone() for _ in
                  range(n_copies(w_deq.numel() * w_deq.element_size()))]
    lib = timed_ms(lambda w: torch.matmul(x, w), [(w,) for w in lib_copies],
                   torch)
    del lib_copies
    rec = dict(kernel="bitplane_gemv", linear=GEMV_NAMES.get((k, n), ""),
               m=m, k=k, n=n, bits=bits, radix=radix, dtype=dname,
               gemv_route=route(m, dt),
               **({"decode_grid": _gemv.decode_launch_grid(k, n, bits, m, dt,
                                                           dev),
                   "sms": _gemv.sm_count(dev),
                   "occupancy": _gemv.decode_occupancy(dev, bits, m, dt)}
                  if route(m, dt) == "decode" else {}),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain, library_ms=lib, library="torch.matmul on "
               "the dequantized weight", bytes=n_bytes, ops=n_ops,
               bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------- grouped (MoE) GEMV phase
def routed_counts(torch, dev, gen, experts, top_k, lanes, tokens, cap):
    """Rows per expert of a routing of ``lanes`` x ``tokens`` tokens to
    ``top_k`` distinct experts each by a random router, kept under the
    per-lane capacity ``cap``: (E,) int32 on ``dev``."""
    scores = torch.rand((lanes, tokens, experts), generator=gen, device=dev)
    top = torch.topk(scores, top_k, dim=-1).indices
    per_lane = torch.zeros((lanes, experts), dtype=torch.int32, device=dev)
    per_lane.scatter_add_(1, top.reshape(lanes, -1),
                          torch.ones_like(top.reshape(lanes, -1),
                                          dtype=torch.int32))
    return per_lane.clamp(max=cap).sum(0).int()


def grouped_case(torch, dev, gen, bits, k, n, counts, dt):
    """Stacked random codes and scales and rows sorted by expert for
    ``counts`` rows an expert, with 3 rows past the last expert's."""
    experts = counts.numel()
    packed = torch.randint(-128, 128, (experts, k * bits // 8, n),
                           generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand((experts, 1, n), generator=gen, device=dev) / 64 + 1e-3
    offsets = torch.zeros(experts + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    rows = int(offsets[-1])
    x = torch.randn((rows + 3, k), generator=gen, device=dev).to(dt)
    return packed, scale, x, offsets, rows


def grouped_parity(torch, dev):
    """The grouped launch against its plain version through each route:
    a decode bound of 8 rows an expert (``grouped_decode``, run twice:
    the same bits) and a chunk bound of 64 (``grouped_tensor_core`` for
    bf16 x, ``grouped_rows`` for float32), with routed counts (some
    experts empty), every row in one expert, and every expert at the
    bound, at both configs' expert shapes and a ragged one."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._gemv import grouped_route
    from repro_torch.kernels.bitplane_gemv.ops import bitplane_gemv_grouped
    from repro_torch.kernels.bitplane_gemv.ref import (
        bitplane_gemv_grouped_ref,
    )

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    shapes = GROUPED_SHAPES + [(200, 300, 6, 2)]
    for k, n, experts, top_k in shapes:
        for mode, bound in GROUPED_BOUNDS.items():
            tokens = 1 if mode == "decode" else 32
            patterns = {
                "routed": routed_counts(torch, dev, gen, experts, top_k, 8,
                                        tokens, bound // 8),
                "one": torch.zeros(experts, dtype=torch.int32, device=dev),
                "full": torch.full((experts,), bound, dtype=torch.int32,
                                   device=dev)}
            patterns["one"][experts // 2] = bound
            for pattern, counts in patterns.items():
                for dt in (torch.bfloat16, torch.float32):
                    for bits in ((4,) if k != 200 else (2, 4, 8)):
                        packed, scale, x, offsets, rows = grouped_case(
                            torch, dev, gen, bits, k, n, counts, dt)
                        path = grouped_route(bound, dt)
                        before = route_counts("bitplane_gemv")[path]
                        y = bitplane_gemv_grouped(
                            packed, scale, x, offsets, max_rows=bound,
                            bits=bits, out_dtype=dt)
                        if route_counts("bitplane_gemv")[path] != before + 1:
                            raise AssertionError(f"grouped: {path} not "
                                                 "counted")
                        r = bitplane_gemv_grouped_ref(
                            packed, scale, x, offsets, max_rows=bound,
                            bits=bits, out_dtype=dt)
                        rtol, atol = gemv_tol(dt, r)
                        err, used = check_close(
                            "bitplane_gemv_grouped", y[:rows], r[:rows],
                            rtol, atol, k=k, n=n, experts=experts,
                            pattern=pattern, bound=bound, bits=bits,
                            dtype=str(dt))
                        if mode == "decode" and not torch.equal(
                                y[:rows], bitplane_gemv_grouped(
                                    packed, scale, x, offsets,
                                    max_rows=bound, bits=bits,
                                    out_dtype=dt)[:rows]):
                            raise AssertionError(
                                f"grouped decode K={k} N={n}: two runs "
                                "differ")
                        worst = max(worst, err)
                        worst_used = max(worst_used, used)
                        n_cases += 1
                        del packed, scale, x, y, r
    torch.cuda.synchronize()
    routes = {r: v for r, v in route_counts("bitplane_gemv").items()
              if r.startswith("grouped_")}
    if not all(routes.values()):
        raise AssertionError(f"grouped parity missed a route: {routes}")
    emit("parity", kernel="bitplane_gemv_grouped", cases=n_cases,
         sweep="(K,N,E) llama4 (5120,8192,16), (8192,5120,16), qwen3 "
               "(4096,1536,128), (1536,4096,128), ragged (200,300,6) x "
               "bound {8 decode, 64 chunk} x counts {routed (experts "
               "empty), one expert at the bound, every expert at the "
               "bound} x {bfloat16, float32} x 4 bits (2/4/8 on the ragged "
               "shape); decode run twice, the same bits",
         tolerance="float32: rtol 1e-5, atol 1e-5*max|ref|; bfloat16 "
                   "output: rtol 2^-7 (one ulp), atol 1e-5*max|ref|",
         max_abs_err=worst, max_share_of_tol=worst_used, routes=routes)


def grouped_time(torch, dev, k, n, experts, top_k, mode, bits=4):
    """Kernel, plain and library times of one grouped call, bf16 x: at
    ``decode``, 8 lanes' tokens routed (the touched experts get 1-8 rows);
    at ``chunk``, every expert at the chunk's bound of 64 rows.  The bound
    counts the codes and scales of the touched experts, x and y; the
    library call is ``torch.bmm`` over the touched experts' bf16 weights
    with each expert's rows padded to the most any has."""
    from repro_torch.roofline import kernel_costs
    from repro_torch.core import unpack_weights
    from repro_torch.kernels._gemv import grouped_route
    from repro_torch.kernels.bitplane_gemv.kernel import (
        bitplane_gemv_grouped_cuda,
    )
    from repro_torch.kernels.bitplane_gemv.ref import (
        bitplane_gemv_grouped_ref,
    )

    dt = torch.bfloat16
    bound = GROUPED_BOUNDS[mode]
    gen = torch.Generator(device=dev).manual_seed(SEED + k + n + bound)
    if mode == "decode":
        counts = routed_counts(torch, dev, gen, experts, top_k, 8, 1, 1)
    else:
        counts = torch.full((experts,), bound, dtype=torch.int32,
                            device=dev)
    packed, scale, x, offsets, rows = grouped_case(torch, dev, gen, bits, k,
                                                   n, counts, dt)

    def kernel(p):
        return bitplane_gemv_grouped_cuda(p, scale, x, offsets,
                                          max_rows=bound, bits=bits,
                                          radix=1, out_dtype=dt)

    def plain(p):
        return bitplane_gemv_grouped_ref(p, scale, x, offsets,
                                         max_rows=bound, bits=bits,
                                         out_dtype=dt)

    y, r = kernel(packed), plain(packed)
    rtol, atol = gemv_tol(dt, r)
    err, _ = check_close("bitplane_gemv_grouped", y[:rows], r[:rows], rtol,
                         atol, k=k, n=n, mode=mode)
    touched = int((counts > 0).sum())
    per_expert = k * n * bits // 8 + 4 * n
    n_bytes, n_ops = kernel_costs.bitplane_gemv_grouped(rows, k, n, bits,
                                                        touched)
    bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
    copies = n_copies(touched * per_expert)
    packs = [packed.clone() for _ in range(copies)]
    ms = timed_ms(kernel, [(p,) for p in packs], torch)
    plain_ms = timed_ms(plain, [(p,) for p in packs[:2]], torch)
    del packs
    # the library call: the touched experts' weights dequantized to bf16,
    # each expert's rows in a slot padded to the most any has
    idx = torch.nonzero(counts).flatten()
    width = int(counts.max())
    w_deq = torch.stack([(unpack_weights(packed[e], bits).float()
                          * scale[e]).to(dt) for e in idx.tolist()])
    slots = torch.zeros((touched, width, k), dtype=dt, device=dev)
    for j, e in enumerate(idx.tolist()):
        lo, c = int(offsets[e]), int(counts[e])
        slots[j, :c] = x[lo:lo + c]
    lib_copies = [w_deq.clone() for _ in
                  range(n_copies(w_deq.numel() * w_deq.element_size()))]
    lib = timed_ms(lambda w: torch.bmm(slots, w), [(w,) for w in lib_copies],
                   torch)
    del lib_copies, w_deq
    rec = dict(kernel="bitplane_gemv_grouped",
               linear=GROUPED_NAMES.get((k, n), ""), mode=mode, k=k, n=n,
               experts=experts, touched=touched, rows=rows,
               max_rows=bound, bits=bits, dtype="bfloat16",
               gemv_route=grouped_route(bound, dt), max_abs_err=err,
               tol=dict(rtol=rtol, atol=atol), ms=ms, plain_ms=plain_ms,
               library_ms=lib, library="torch.bmm on the touched experts' "
               "dequantized bf16 weights", bytes=n_bytes, ops=n_ops,
               bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ----------------------------------------------------- attention phase
def attn_pools(torch, dev, gen, kind, n_pages, page, hkv, dh):
    if kind == "int8":
        kp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, page, hkv, dh), generator=gen,
                           device=dev).to(torch.int8)
        ks = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).to(torch.bfloat16)
        vs = (0.004 + 0.016 * torch.rand((n_pages, page, hkv), generator=gen,
                                         device=dev)).to(torch.bfloat16)
        return kp, vp, ks, vs
    dt = getattr(torch, kind)
    kp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    vp = torch.randn((n_pages, page, hkv, dh), generator=gen, device=dev)
    return kp.to(dt), vp.to(dt), None, None


def attn_tol(kind):
    # float32 pools: sum order; bf16 / int8 pools: the output is bf16 and
    # p is rounded to bf16 before PV (after a float32 softmax whose exp
    # differs from the plain version's in the last bit): two bf16 ulps.
    return (1e-5, 1e-5) if kind == "float32" else (2 ** -7, 2 ** -7)


def attn_parity(torch, dev):
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention,
        paged_prefill_attention,
    )
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_ref,
    )

    from repro_torch.kernels import _build

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    gen_deep = torch.Generator(device=dev).manual_seed(SEED + 12)
    b, hkv, g, dh, page, nblk, c = 8, 2, 8, 128, 16, 24, 32
    worst = {"decode": [0.0, 0.0], "prefill": [0.0, 0.0]}
    n_cases = {"decode": 0, "prefill": 0}
    routes = {}
    for kind in ("float32", "bfloat16", "int8"):
        kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1,
                                    page, hkv, dh)
        bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
              ).reshape(b, nblk).int()
        qdt = torch.float32 if kind == "float32" else torch.bfloat16
        rtol, atol = attn_tol(kind)
        for window in (0, 37):
            # decode: ragged last blocks, one lane at position 0, one full
            cur = torch.tensor([0, 15, 16, 33, 129, 250, 301,
                                page * nblk - 1], dtype=torch.int32,
                               device=dev)
            q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                            device=dev).to(qdt)
            y = paged_attention(q, kp, vp, bt, cur, window, ks, vs)
            r = paged_attention_ref(q, kp, vp, bt, cur, window, ks, vs)
            res = check_close("paged_decode_attention", y, r, rtol, atol,
                              kind=kind, window=window)
            worst["decode"] = [max(a, b) for a, b in zip(worst["decode"],
                                                          res)]
            n_cases["decode"] += 1
            # prefill: mid-page pos0, a ragged last lane, an idle lane
            # (lane 7); then every lane past 256 tokens of context (several
            # steps of the page walk), mid-page, the last lane ragged
            for pos0, seq_cut, idle in (
                    ([0, 7, 16, 45, 100, 201, 300, 120], 5, True),
                    ([257, 270, 300, 333, 290, 262, 345, 280], 9, False)):
                pos0 = torch.tensor(pos0, dtype=torch.int32, device=dev)
                seq = pos0 + c
                seq[6] = pos0[6] + seq_cut
                if idle:
                    seq[7] = pos0[7]
                qp = torch.randn((b, c, hkv * g, dh),
                                 generator=gen if idle else gen_deep,
                                 device=dev).to(qdt)
                before = route_counts("paged_prefill_attention")
                y = paged_prefill_attention(qp, kp, vp, bt, pos0, seq,
                                            window, ks, vs)
                took = [name for name, n in
                        route_counts("paged_prefill_attention").items()
                        if n > before[name]]
                routes[kind] = took
                r = paged_prefill_ref(qp, kp, vp, bt, pos0, seq, window, ks,
                                      vs)
                # the idle lane's rows attend no key; the engine discards
                # them
                keep = 7 if idle else b
                res = check_close("paged_prefill_attention", y[:keep],
                                  r[:keep], rtol, atol, kind=kind,
                                  window=window, pos0=pos0.tolist())
                worst["prefill"] = [max(a, b) for a, b in
                                    zip(worst["prefill"], res)]
                n_cases["prefill"] += 1
    torch.cuda.synchronize()
    want = {"float32": ["cuda_core"], "bfloat16": ["tensor_core"],
            "int8": ["tensor_core"]}
    if routes != want:
        raise AssertionError(f"paged_prefill_attention routes {routes}")
    for name, (err, used) in worst.items():
        emit("parity", kernel=f"paged_{name}_attention",
             cases=n_cases[name],
             sweep="pools {float32,bfloat16,int8} x window {0,37}; G=8, "
                   "Dh=128, page 16, ragged last blocks, mid-page pos0"
                   + ("; pos0 0-300 and 257-345" if name == "prefill"
                      else ""),
             tolerance="float32: rtol=atol=1e-5; bf16 / int8 pools: "
                       "rtol=atol=2^-7", max_abs_err=err,
             max_share_of_tol=used,
             **({"routes": routes} if name == "prefill" else {}))


def prefill_head_dim_parity(torch, dev):
    """The chunked prefill's tensor-core route at head dims past 128 (256,
    and 192 padded to it), and its CUDA-core route past the tiles (320,
    bf16 queries): bf16 and int8 pools, windows 0 and 37, pos0 past 256
    tokens of context, a ragged and an idle lane."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.ops import (
        paged_prefill_attention,
    )
    from repro_torch.kernels.paged_attention.ref import paged_prefill_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, hkv, g, page, nblk, c = 8, 2, 8, 16, 24, 32
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for kind in ("bfloat16", "int8"):
        for dh in (192, 256, 320):
            kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1,
                                        page, hkv, dh)
            bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
                  ).reshape(b, nblk).int()
            rtol, atol = attn_tol(kind)
            for window in (0, 37):
                pos0 = torch.tensor([0, 7, 16, 45, 100, 201, 300, 120],
                                    dtype=torch.int32, device=dev)
                seq = pos0 + c
                seq[6] = pos0[6] + 5
                seq[7] = pos0[7]
                q = torch.randn((b, c, hkv * g, dh), generator=gen,
                                device=dev).bfloat16()
                y = paged_prefill_attention(q, kp, vp, bt, pos0, seq,
                                            window, ks, vs)
                r = paged_prefill_ref(q, kp, vp, bt, pos0, seq, window, ks,
                                      vs)
                err, used = check_close("paged_prefill_attention", y[:7],
                                        r[:7], rtol, atol, kind=kind, dh=dh,
                                        window=window)
                worst, worst_used = max(worst, err), max(worst_used, used)
                n_cases += 1
    torch.cuda.synchronize()
    routes = route_counts("paged_prefill_attention")
    if routes != {"cuda_core": n_cases // 3, "tensor_core": 2 * n_cases // 3}:
        raise AssertionError(f"prefill at D 192/256/320: routes {routes}")
    emit("parity", kernel="paged_prefill_attention", cases=n_cases,
         sweep="head dims {192 (padded), 256: tensor_core; 320: "
               "cuda_core} x pools {bfloat16,int8} x window {0,37}; bf16 "
               "queries, G=8, page 16, pos0 0-300, a ragged and an idle "
               "lane", tolerance="rtol=atol=2^-7", max_abs_err=worst,
         max_share_of_tol=worst_used, routes=routes)


def decode_split_parity(torch, dev):
    """Paged decode attention's splits: a 4096-key table (64 splits of 64),
    lanes at position 0 (one split attended), mid-context and the last
    slot, windows 0 and 37; G 1 / 5 / 8 / 12 (one and two passes of 8
    heads), Dh 64 / 112 / 128, page 16 and 32, three pool types; every call
    twice, the same bits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, hkv, keys = 4, 2, 4096
    worst, worst_used, n_cases = 0.0, 0.0, 0
    for kind in ("float32", "bfloat16", "int8"):
        qdt = torch.float32 if kind == "float32" else torch.bfloat16
        rtol, atol = attn_tol(kind)
        for page in (16, 32):
            nblk = keys // page
            for dh in (64, 112, 128):
                kp, vp, ks, vs = attn_pools(torch, dev, gen, kind,
                                            b * nblk + 1, page, hkv, dh)
                bt = (1 + torch.randperm(b * nblk, generator=gen,
                                         device=dev)).reshape(b, nblk).int()
                cur = torch.tensor([0, 1000, 2222, keys - 1],
                                   dtype=torch.int32, device=dev)
                for g in (1, 5, 8, 12):
                    q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                                    device=dev).to(qdt)
                    for window in (0, 37):
                        y = paged_attention(q, kp, vp, bt, cur, window, ks,
                                            vs)
                        if not torch.equal(y, paged_attention(
                                q, kp, vp, bt, cur, window, ks, vs)):
                            raise AssertionError(
                                f"paged_decode_attention {kind} G={g} "
                                f"Dh={dh}: two runs differ")
                        r = paged_attention_ref(q, kp, vp, bt, cur, window,
                                                ks, vs)
                        err, used = check_close(
                            "paged_decode_attention", y, r, rtol, atol,
                            kind=kind, page=page, dh=dh, g=g, window=window)
                        worst, worst_used = (max(worst, err),
                                             max(worst_used, used))
                        n_cases += 1
    torch.cuda.synchronize()
    emit("parity", kernel="paged_decode_attention", cases=n_cases,
         sweep="pools {float32,bfloat16,int8} x page {16,32} x Dh "
               "{64,112,128} x G {1,5,8,12} x window {0,37}; 4096-key "
               "table, lanes at 0, 1000, 2222, 4095; every call twice",
         tolerance="float32: rtol=atol=1e-5; bf16 / int8 pools: "
                   "rtol=atol=2^-7", max_abs_err=worst,
         max_share_of_tol=worst_used,
         launches=_build.LAUNCHES["paged_decode_attention"])


def _gathered(torch, kp, vp, ks, vs, bt):
    """The logical K/V view as bf16 ``(B, Hkv, T, Dh)``, dequantized for
    int8 pools: the input of the library yardstick."""
    from repro_torch.kernels.paged_attention.ref import gather_pages

    kg, vg = gather_pages(kp, bt), gather_pages(vp, bt)
    if ks is not None:
        kg = kg.float() * gather_pages(ks, bt).float()[..., None]
        vg = vg.float() * gather_pages(vs, bt).float()[..., None]
    dt = torch.float32 if kp.dtype == torch.float32 else torch.bfloat16
    return (kg.to(dt).transpose(1, 2).contiguous(),
            vg.to(dt).transpose(1, 2).contiguous())


def attn_time(torch, dev, kind, mode, dh=128):
    """Kernel / plain / library times of one main-path attention call:
    8 lanes, G=8, Dh=128 (or ``dh``), page 16, contexts of 33-332
    tokens."""
    import torch.nn.functional as F

    from repro_torch.roofline import kernel_costs
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda,
        paged_prefill_attention_cuda,
        prefill_route,
    )
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b, hkv, g, page, c = 8, 2, 8, 16, 32
    nblk = 1024 // page                  # the main path's max_len
    kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1, page,
                                hkv, dh)
    bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
          ).reshape(b, nblk).int()
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    eb = kp.element_size()
    t_pos = torch.arange(nblk * page, device=dev)
    if mode == "decode":
        cur = torch.tensor([40, 77, 129, 166, 200, 251, 300, 331],
                           dtype=torch.int32, device=dev)
        q = torch.randn((b, hkv, g, dh), generator=gen, device=dev).to(qdt)
        keys = int((cur + 1).sum())
        pairs = keys * hkv * g
        call = lambda kk, vv, kss, vss: paged_decode_attention_cuda(  # noqa
            q, kk, vv, bt, cur, 0, kss, vss)
        plain = lambda kk, vv, kss, vss: paged_attention_ref(  # noqa
            q.reshape(b, 1, hkv * g, dh), kk, vv, bt, cur, 0, kss, vss)
        out = call(kp, vp, ks, vs).reshape(b, 1, hkv * g, dh).to(qdt)
        ref = plain(kp, vp, ks, vs)
        mask = (t_pos[None, :] <= cur[:, None].long())[:, None, None, :]
        q_lib = q.reshape(b, hkv * g, 1, dh)
        n_bytes, n_ops = kernel_costs.paged_decode_attention(
            b, hkv, g, dh, nblk, keys, eb, q.element_size(), ks is not None)
    else:
        pos0 = torch.tensor([0, 32, 64, 100, 150, 200, 250, 268],
                            dtype=torch.int32, device=dev)
        seq = pos0 + c
        seq[-1] = pos0[-1] + 27          # a ragged last lane
        q = torch.randn((b, c, hkv, g, dh), generator=gen,
                        device=dev).to(qdt)
        keys = int(seq.sum())
        qpos = pos0[:, None].long() + torch.arange(c, device=dev)[None]
        valid_rows = qpos < seq[:, None]
        pairs = int(((qpos + 1) * valid_rows).sum()) * hkv * g
        call = lambda kk, vv, kss, vss: paged_prefill_attention_cuda(  # noqa
            q, kk, vv, bt, pos0, seq, 0, kss, vss)
        plain = lambda kk, vv, kss, vss: paged_prefill_ref(  # noqa
            q.reshape(b, c, hkv * g, dh), kk, vv, bt, pos0, seq, 0, kss, vss)
        out = call(kp, vp, ks, vs).reshape(b, c, hkv * g, dh).to(qdt)
        ref = plain(kp, vp, ks, vs)
        lim = torch.minimum(seq, pos0 + c).long()
        mask = ((t_pos[None, None, :] <= qpos[:, :, None])
                & (t_pos[None, None, :] < lim[:, None, None]))[:, None]
        q_lib = q.reshape(b, c, hkv * g, dh).transpose(1, 2).contiguous()
        n_bytes, n_ops = kernel_costs.paged_prefill_attention(
            b, c, hkv, g, dh, nblk, keys, pairs, eb, q.element_size(),
            ks is not None)
        out, ref = out[valid_rows], ref[valid_rows]
    rtol, atol = attn_tol(kind)
    err, _ = check_close(f"paged_{mode}_attention", out, ref, rtol, atol,
                         kind=kind)
    kv_bytes = keys * hkv * dh * eb * 2
    bms, by = bound_ms(n_bytes, n_ops, "float32" if kind == "float32"
                       else "bfloat16")
    # rotate whole pools so the pages read across the run exceed L2
    copies = min(n_copies(kv_bytes), 128)
    pools = [(kp.clone(), vp.clone(),
              None if ks is None else ks.clone(),
              None if vs is None else vs.clone()) for _ in range(copies)]
    ms = timed_ms(call, pools, torch)
    plain_ms = timed_ms(plain, pools[:4], torch)
    del pools
    kg, vg = _gathered(torch, kp, vp, ks, vs, bt)
    views = [(kg.clone(), vg.clone()) for _ in range(min(copies, 8))]
    lib = timed_ms(lambda kk, vv: F.scaled_dot_product_attention(
        q_lib, kk, vv, attn_mask=mask, enable_gqa=True), views, torch)
    del views
    rec = dict(kernel=f"paged_{mode}_attention", pools=kind, lanes=b,
               chunk=c if mode == "prefill" else 1, keys=keys, dh=dh,
               **({"route": prefill_route(qdt, kp.dtype, dh, g)}
                  if mode == "prefill" else {}),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=lib,
               library="F.scaled_dot_product_attention over the gathered "
                       "bf16 view", bytes=n_bytes, ops=n_ops, bound_ms=bms,
               bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------- int8 bit-parallel kernel
def int8_tol(torch, q, scale, x, dt):
    """Per-element bound: a float32 sum of K products in two orders,
    within 16·√K·2^-24 of Σ|x|·|q|·scale (rounding errors of a K-term sum
    grow as √K; 16 covers their spread); a bfloat16 output adds one rounding
    of a sum that may differ in its last bits, one bf16 ulp (2^-7)."""
    s = (x.float().abs() @ q.float().abs()) * scale
    atol = 2.0 ** -20 * math.sqrt(q.shape[0]) * s
    return (0.0 if dt == torch.float32 else 2 ** -7), atol


def int8_case(torch, dev, gen, k, n, m, dt):
    from repro_torch.core import quantize_symmetric

    w = torch.randn((k, n), generator=gen, device=dev)
    q, scale = quantize_symmetric(w, 8)
    x = torch.randn((m, k), generator=gen, device=dev).to(dt)
    return q, scale, x


def int8_parity(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_matvec.ops import int8_matvec
    from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst, worst_used, n_cases = 0.0, 0.0, 0
    cases = [((k, n), m, dt) for (k, n) in GEMV_SHAPES + [INT8_RAGGED]
             for m in (1, 3, 8, 256)
             for dt in (torch.float32, torch.bfloat16)]
    # ragged prefill M, K and N: the tensor-core route in bf16, the rows
    # route in float32 (at M = 100)
    cases += [((k, n), m, dt) for (k, n) in TC_RAGGED for m in TC_ROWS
              for dt in ((torch.float32, torch.bfloat16) if m < 1000
                         else (torch.bfloat16,))]
    for (k, n), m, dt in cases:
        q, scale, x = int8_case(torch, dev, gen, k, n, m, dt)
        y = int8_matvec(q, scale, x, out_dtype=dt)
        r = int8_matvec_ref(q, scale, x, out_dtype=dt)
        rtol, atol = int8_tol(torch, q, scale, x, dt)
        err, used = check_close("int8_matvec", y, r, rtol, atol, m=m, k=k,
                                n=n, dtype=str(dt))
        worst, worst_used = max(worst, err), max(worst_used, used)
        n_cases += 1
    torch.cuda.synchronize()
    routes = route_counts("int8_matvec")
    if not all(routes.values()):
        raise AssertionError(f"int8_matvec parity missed a route: {routes}")
    emit("parity", kernel="int8_matvec", cases=n_cases,
         sweep="M{1,3,8,256} x 4 qwen2.5-3b shapes + ragged K=2001, N=1003 "
               "x {float32,bfloat16} x and output; M{100,8192} x (K,N)"
               "{(520,300),(200,1983),(768,3352)} x bfloat16, float32 at "
               "M=100",
         tolerance="|y - ref| <= rtol*|ref| + 16*sqrt(K)*2^-24 * "
                   "(|x| @ |q|)*scale per element; rtol 0 for float32, "
                   "2^-7 (one ulp) for bfloat16 output",
         max_abs_err=worst, max_share_of_tol=worst_used, routes=routes)


def int8_time(torch, dev, m, k, n, dt=None):
    from repro_torch.roofline import kernel_costs
    from repro_torch.kernels._gemv import decode_launch_grid, route
    from repro_torch.kernels.int8_matvec.kernel import int8_matvec_cuda
    from repro_torch.kernels.int8_matvec.ref import int8_matvec_ref

    dt = dt or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + m + k + n)
    q, scale, x = int8_case(torch, dev, gen, k, n, m, dt)
    y = int8_matvec_cuda(q, scale, x, out_dtype=dt)
    r = int8_matvec_ref(q, scale, x, out_dtype=dt)
    rtol, atol = int8_tol(torch, q, scale, x, dt)
    err, _ = check_close("int8_matvec", y, r, rtol, atol, m=m, k=k, n=n)
    n_bytes, n_ops = kernel_costs.int8_matvec(m, k, n, x.element_size())
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    bms, by = bound_ms(n_bytes, n_ops, dname)
    qs = [q.clone() for _ in range(n_copies(k * n))]
    ms = timed_ms(lambda qq: int8_matvec_cuda(qq, scale, x, out_dtype=dt),
                  [(qq,) for qq in qs], torch)
    plain = timed_ms(lambda qq: int8_matvec_ref(qq, scale, x, out_dtype=dt),
                     [(qq,) for qq in qs[:8]], torch)
    del qs
    w_deq = (q.float() * scale).to(dt)
    lib_copies = [w_deq.clone() for _ in
                  range(n_copies(w_deq.numel() * w_deq.element_size()))]
    lib = timed_ms(lambda w: torch.matmul(x, w), [(w,) for w in lib_copies],
                   torch)
    del lib_copies
    path = route(m, dt)
    rec = dict(kernel="int8_matvec", linear=GEMV_NAMES.get((k, n), ""), m=m,
               k=k, n=n, dtype=dname, gemv_route=path,
               **({"decode_grid": decode_launch_grid(k, n, 8, m, dt, dev)}
                  if path == "decode" else {}),
               earlier_ms=EARLIER_MS.get(("int8_matvec", m, k, n)),
               max_abs_err=err,
               tol=dict(rtol=rtol, atol_max=float(atol.max())), ms=ms,
               plain_ms=plain, library_ms=lib,
               library="torch.matmul on the dequantized bf16 weight",
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------------- the engine's path
def engine_path(torch, dev):
    """The paper's engine path on the card; see the module docstring.

    Launches are read before the timing loops, so they count the path's
    own calls: one int8 launch and one bit-plane launch in the demo, and
    per dimension one int8 and two bit-plane (radix 1, 2) launches.
    """
    import numpy as np

    from repro_torch import paper_demo
    from repro_torch.core import QuantizedLinear, gemv, pack_weights
    from repro_torch.core.controller import run_gemv
    from repro_torch.core.isa import MAX_ELEMS
    from repro_torch.core.latency_model import IMAGINE_FSYS_MHZ
    from repro_torch.core.tile_array import u55_geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels.int8_matvec import int8_matvec

    dims = ENGINE_DIMS + (u55_geometry().max_square_gemv(8),)
    torch.cuda.synchronize()
    _build.reset_launches()
    demo = paper_demo.run(96, device=dev)
    if demo["backend"] != "cuda":
        raise AssertionError(f"engine: demo resolved {demo['backend']}")
    cases = []
    for d in dims:
        rng = np.random.default_rng(SEED + d)
        r_max = (2 ** 24 - 1) // (d * 127)   # |partial sums| < 2^24
        w = rng.integers(-127, 128, size=(d, d))
        x = rng.integers(-r_max, r_max + 1, size=(d,))
        want = (w @ x).astype(np.float64)
        t0 = time.perf_counter()
        res = run_gemv(w, x, rows=16, cols=-(-d // MAX_ELEMS))
        model_s = time.perf_counter() - t0
        # the engine's weight is (K, N) with y = x @ W: the codes of w.T
        codes = torch.as_tensor(np.ascontiguousarray(w.T), dtype=torch.int8,
                                device=dev)
        ql = QuantizedLinear(pack_weights(codes, 8),
                             torch.ones((1, d), device=dev), 8, d, d)
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        outs = {"tile_model": res.y.astype(np.float64),
                "bitplane_radix1": gemv(ql, xt, radix=1),
                "bitplane_radix2": gemv(ql, xt, radix=2),
                "int8_matvec": int8_matvec(ql.packed, ql.scale, xt)}
        for name, y in outs.items():
            if isinstance(y, torch.Tensor):
                y = y.double().cpu().numpy()
            if not np.array_equal(y, want):
                raise AssertionError(
                    f"engine d={d}: {name} differs from w @ x in "
                    f"{int((y != want).sum())} of {d} elements")
        cases.append(dict(d=d, r_max=r_max, ql=ql, xt=xt, res=res,
                          model_s=model_s))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    int8_routes = route_counts("int8_matvec")
    want_launches = {"int8_matvec": 1 + len(dims),
                     "bitplane_gemv": 1 + 2 * len(dims)}
    for kernel, n in want_launches.items():
        if launches[kernel] != n:
            raise AssertionError(f"engine: {kernel} launched "
                                 f"{launches[kernel]} times, expected {n}")
    rows = [dict(d=c["d"], r_max=c["r_max"], exact=True,
                 controller_cycles=c["res"].cycles,
                 controller_instrs=c["res"].instrs,
                 fpga_us_at_737mhz=c["res"].cycles / IMAGINE_FSYS_MHZ,
                 model_host_s=c["model_s"], **engine_times(torch, c))
            for c in cases]
    rec = dict(demo=dict(dim=demo["dim"], cycles=demo["cycles"],
                         fpga_us_at_737mhz=demo["exec_us"],
                         rel_err_bitplane=demo["rel_err_bitplane"],
                         rel_err_int8=demo["rel_err_int8"]),
               exact=rows, launches=launches, int8_routes=int8_routes)
    emit("engine", **rec)
    return rec


def engine_times(torch, case):
    """Card µs of the three kernels on one exact-GEMV case (M = 1, float32
    x and output) beside the bytes bound of the int8 weight."""
    from repro_torch.kernels.bitplane_gemv.kernel import bitplane_gemv_cuda
    from repro_torch.kernels.int8_matvec.kernel import int8_matvec_cuda

    d, ql, x = case["d"], case["ql"], case["xt"][None]
    n_bytes = d * d + 4 * d + 4 * d + 4 * d
    bms, by = bound_ms(n_bytes, 2 * d * d, "float32")
    packs = [(ql.packed.clone(),) for _ in range(n_copies(d * d))]
    card = {f"bitplane_radix{r}_us": 1e3 * timed_ms(
        lambda p, _r=r: bitplane_gemv_cuda(p, ql.scale, x, bits=8, radix=_r),
        packs, torch) for r in (1, 2)}
    card["int8_matvec_us"] = 1e3 * timed_ms(
        lambda p: int8_matvec_cuda(p, ql.scale, x), packs, torch)
    return dict(card_us=card, bytes=n_bytes, bound_us=1e3 * bms,
                bound_by=by)


# ----------------------------------------------------- serving phases
def full_config(**changes):
    from repro_torch.config import get_arch

    return dataclasses.replace(get_arch("qwen2.5-3b"), **changes)


def prompts_for(cfg, n, lo, hi, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1))
                         ).tolist() for _ in range(n)]


def build_engine(torch, dev, cfg, weight_bits, kv_bits, *, n_slots=8,
                 max_len=1024, max_new=32, params=None, mode="auto",
                 cuda_graphs=True, serve_kw=None, clock=None, chaos=None,
                 mesh=None, **engine_kw):
    from repro_torch.config import EngineConfig, ServeConfig
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    if params is None:
        # one layer at a time, packed as it is drawn: the dense bf16 tree
        # of the whole model never exists on the card
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, engine_bits=weight_bits)
    scfg = ServeConfig(max_new_tokens=max_new,
                       engine=EngineConfig(weight_bits=weight_bits,
                                           kv_bits=kv_bits, **engine_kw),
                       page_size=16, prefill_chunk=32, **(serve_kw or {}))
    eng = ServeEngine(cfg, params, scfg, n_slots=n_slots, max_len=max_len,
                      seed=SEED, mode=mode, cuda_graphs=cuda_graphs,
                      clock=clock, device=dev, chaos=chaos, mesh=mesh)
    return eng, params


def serve(torch, name, eng, prompts, max_new, *, first=None,
          priorities=None, check_step=None):
    """Submit, run to the end, check every request and report; returns
    the record and every request's tokens.  ``first``: submit only that
    many prompts at the start, and the rest once those have completed
    their prefill.  ``priorities``: each prompt's ``priority``.
    ``check_step(eng, reqs)`` runs after every step.  Without a chaos
    injector no request may be retried or quarantined."""
    import numpy as np

    from repro_torch.kernels import _build

    first = len(prompts) if first is None else first
    priorities = priorities or ["default"] * len(prompts)

    def submit(lo, hi):
        return [eng.submit(p, priority=pr)
                for p, pr in zip(prompts[lo:hi], priorities[lo:hi])]

    reqs = submit(0, first)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    # the engine's own loop (``run``), one ``step`` at a time, with graph
    # replays counted through their capture's launches.  Paged mode: the
    # GEMV's tensor-core route must launch in exactly the steps that ran a
    # prefill chunk, its decode route in exactly those that ran a decode
    # step (each adds one entry to ``eng.timings``) and, for an untied
    # lm_head, once in each that ran a chunk, and its rows route never; the
    # chunked prefill's tensor-core route once a layer in every step that
    # ran a chunk, its CUDA-core route never.  A moe layer's three expert
    # linears take the grouped launch instead: grouped_tensor_core once
    # each in a step that ran a chunk, grouped_decode once each in one
    # that ran a decode step, grouped_rows never (none for the other
    # families).  Slots mode: every prompt token admitted and every decode
    # step is one full-sequence decode step, so the decode routes launch
    # a full step's GEMVs for each, and no other route or attention kernel
    # ever launches.  A float32 model's chunks take the GEMVs' rows routes
    # and the prefill attention's CUDA-core route in the same places, and
    # the tensor-core routes never
    slots = eng.mode == "slots"
    f32 = eng.cfg.dtype == "float32"
    chunk, unused = ("rows", "tensor_core") if f32 else ("tensor_core",
                                                          "rows")
    attn_chunk, attn_unused = (("cuda_core", "tensor_core") if f32
                               else ("tensor_core", "cuda_core"))
    # an untied lm_head is packed too: one more GEMV a decode step, and in
    # paged mode one at M = n_slots for each prefill chunk's last tokens
    head = int(not isinstance(eng.params.get("lm_head", {}), dict))
    family, n_layers = eng.cfg.family, eng.cfg.n_layers
    flat = {"ssm": 2, "hybrid": 2,
            "moe": 4 + 3 * bool(eng.cfg.n_shared_experts)}.get(family, 7)
    # the hybrid family's shared block: its seven linears at every site
    sites = n_layers // eng.cfg.attn_every if family == "hybrid" else 0
    per_step = flat * n_layers + 7 * sites + head
    per_grouped = 3 * n_layers if family == "moe" else 0
    gemv_launches = {"prefill": 0, "decode": 0}
    grouped_launches = {"prefill": 0, "decode": 0}
    attn_launches, balanced_launches = 0, 0
    t0 = time.perf_counter()
    done = []
    while eng.has_work() or len(reqs) < len(prompts):
        if len(reqs) < len(prompts) and all(r.last_logits is not None
                                            for r in reqs):
            reqs += submit(first, len(prompts))
        ran = {part: len(eng.timings[part]) for part in gemv_launches}
        if slots:
            free = sum(r is None for r in eng.slot_req)
            admitted = sum(len(r.prompt) for r in list(eng.queue)[:free])
        before = route_counts("bitplane_gemv")
        before_attn = route_counts("paged_prefill_attention")
        balanced = _build.BALANCED_LAUNCHES
        done.extend(eng.step())
        moved = {k: v - before[k]
                 for k, v in route_counts("bitplane_gemv").items()}
        if _build.BALANCED_LAUNCHES - balanced != moved["decode"]:
            raise AssertionError(
                f"{name}: {_build.BALANCED_LAUNCHES - balanced} balanced "
                f"decode launches in a step of {moved['decode']}")
        balanced_launches += moved["decode"]
        grouped = {k.removeprefix("grouped_"): moved.pop(k)
                   for k in list(moved) if k.startswith("grouped_")}
        moved_attn = {k: v - before_attn[k] for k, v in
                      route_counts("paged_prefill_attention").items()}
        ran = {part: len(eng.timings[part]) > n for part, n in ran.items()}
        if slots:
            want = per_step * (admitted + ran["decode"])
            want_grouped = {"decode": per_grouped * (admitted
                                                     + ran["decode"]),
                            "rows": 0, "tensor_core": 0}
            if moved != {"decode": want, "rows": 0, "tensor_core": 0}:
                raise AssertionError(f"{name}: GEMV routes {moved} in a "
                                     f"step that ran {ran}, {admitted} "
                                     f"prompt tokens: wanted {want}")
            want_attn = 0
        else:
            want_grouped = {"decode": per_grouped * ran["decode"],
                            chunk: per_grouped * ran["prefill"], unused: 0}
            lm_head = head * ran["prefill"]
            if ((moved[chunk] > 0) != ran["prefill"]
                    or (moved["decode"] - lm_head > 0) != ran["decode"]
                    or moved["decode"] < lm_head or moved[unused]):
                raise AssertionError(f"{name}: GEMV routes {moved} in a "
                                     f"step that ran {ran}")
            want_attn = eng.cfg.n_layers * ran["prefill"]
        if moved_attn != {attn_unused: 0, attn_chunk: want_attn}:
            raise AssertionError(f"{name}: prefill attention routes "
                                 f"{moved_attn} in a step that ran {ran}")
        if grouped != want_grouped:
            raise AssertionError(f"{name}: grouped GEMV routes {grouped} in "
                                 f"a step that ran {ran}: wanted "
                                 f"{want_grouped}")
        gemv_launches["prefill"] += moved[chunk]
        gemv_launches["decode"] += moved["decode"]
        grouped_launches["prefill"] += grouped[chunk]
        grouped_launches["decode"] += grouped["decode"]
        attn_launches += moved_attn[attn_chunk]
        if check_step is not None:
            check_step(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if len(done) != len(reqs):
        raise AssertionError(f"{name}: {len(done)} of {len(reqs)} finished")
    for r in reqs:
        if not r.done or len(r.output) != max_new:
            raise AssertionError(
                f"{name}: request {r.rid} done={r.done} with "
                f"{len(r.output)} tokens, wanted {max_new}")
        if not all(0 <= t < eng.cfg.vocab_size for t in r.output):
            raise AssertionError(f"{name}: token outside the vocabulary")
        # the engine retries or quarantines a lane whose logits are not
        # finite; the last ones are held here too.  A request retried or
        # preempted after its last token retires before its re-prefill
        # completes, with no logits
        if r.last_logits is None:
            if not (r.retries or r.preemptions):
                raise AssertionError(f"{name}: request {r.rid} has no "
                                     "logits")
        elif not np.isfinite(r.last_logits).all():
            raise AssertionError(f"{name}: non-finite logits")
    if eng.chaos is None and (eng.retried or eng.quarantined):
        raise AssertionError(f"{name}: {eng.retried} retries, "
                             f"{eng.quarantined} quarantines")
    n_tok = sum(len(r.output) for r in reqs)
    n_prompt = sum(len(p) for p in prompts)
    dec, pf = eng.timings["decode"], eng.timings["prefill"]
    ttft = [r.ttft for r in reqs]
    rec = dict(
        model=eng.cfg.name, mode=eng.mode, cuda_graphs=eng.cuda_graphs,
        layers=eng.cfg.n_layers, d_model=eng.cfg.d_model,
        vocab=eng.cfg.vocab_size, weight_bits=eng.plan.bits,
        kv_bits=eng.plan.kv_bits, gemv_backend=eng.plan.backend,
        attn_backend=eng.attn_backend, slots=eng.n_slots,
        requests=len(reqs), prompt_tokens=n_prompt, new_tokens=n_tok,
        seconds=wall, tok_s=n_tok / wall, decode_steps=len(dec),
        decode_step_ms=1e3 * sum(dec) / max(len(dec), 1),
        decode_step_ms_p50=1e3 * float(np.median(dec)) if dec else None,
        # paged: one entry a prefill chunk; slots: one a prompt's
        # sequential prefill
        prefill_chunks=len(pf),
        prefill_chunk_ms=1e3 * sum(pf) / max(len(pf), 1),
        prefill_chunk_ms_p50=1e3 * float(np.median(pf)) if pf else None,
        prefill_tok_s=n_prompt / max(sum(pf), 1e-12),
        prefill_computed=eng.prefill_computed,
        ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
        ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
        sched=eng.scfg.sched, audit=eng.scfg.audit,
        prefix_stats=eng.prefix_stats(),
        capture_s=sum(eng.timings["capture"]),
        audit_s=sum(eng.timings["audit"]),
        graphs_captured=len(eng.timings["capture"]),
        preemptions=eng.preemptions, retried=eng.retried,
        quarantined=eng.quarantined,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches, route_launches=dict(_build.ROUTE_LAUNCHES),
        gemv_tensor_core_launches=gemv_launches["prefill"],
        gemv_decode_launches=gemv_launches["decode"],
        gemv_balanced_launches=balanced_launches,
        gemv_grouped_tensor_core_launches=grouped_launches["prefill"],
        gemv_grouped_decode_launches=grouped_launches["decode"],
        prefill_attention_tensor_core_launches=attn_launches,
        prefill_attention_per_chunk=attn_launches / max(len(pf), 1))
    emit(name, **rec)
    kernels = ("bitplane_gemv",) if slots else PAGED_KERNELS
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched: {missing}")
    if not gemv_launches["decode"] or (not slots
                                       and not gemv_launches["prefill"]):
        raise AssertionError(f"{name}: GEMV launches {gemv_launches}")
    if family == "moe" and not (grouped_launches["decode"] and (
            slots or grouped_launches["prefill"])):
        raise AssertionError(f"{name}: grouped launches {grouped_launches}")
    if eng.cuda_graphs and eng.timings["capture"] == []:
        raise AssertionError(f"{name}: no step was captured")
    return rec, [r.output for r in reqs]


def graphs_against_eager(torch, dev, name, cfg, weight_bits, kv_bits,
                         prompts, max_new, mode="auto", params=None,
                         graph_rec=None, graph_tokens=None, **kw):
    """The same prompts through an engine with CUDA graphs and one with
    ``cuda_graphs=False`` (given the graph run's record and tokens, only
    the eager one runs): greedy tokens must be identical, as the graphs
    replay the eager step's kernels on the same inputs.  Emits both runs'
    step times side by side."""
    runs = {}
    for graphs in (True, False):
        if graphs and graph_rec is not None:
            runs[graphs] = (graph_rec, graph_tokens)
            continue
        eng, params = build_engine(torch, dev, cfg, weight_bits, kv_bits,
                                   params=params, mode=mode,
                                   cuda_graphs=graphs, max_new=max_new, **kw)
        run = f"{name}_{'graphs' if graphs else 'eager'}"
        runs[graphs] = serve(torch, run, eng, prompts, max_new)
        del eng
        torch.cuda.empty_cache()
    (g, g_tok), (e, e_tok) = runs[True], runs[False]
    same = sum(a == b for a, b in zip(g_tok, e_tok))
    keys = ("tok_s", "decode_step_ms", "prefill_chunk_ms", "prefill_tok_s",
            "peak_mem_gib")
    emit(f"{name}_graphs_vs_eager", model=cfg.name, layers=cfg.n_layers,
         mode=g["mode"], requests=len(prompts), identical_requests=same,
         capture_s=g["capture_s"],
         **{f"{k}_graphs": g[k] for k in keys},
         **{f"{k}_eager": e[k] for k in keys},
         tok_s_ratio=g["tok_s"] / e["tok_s"],
         decode_step_ratio=e["decode_step_ms"] / g["decode_step_ms"])
    if same != len(prompts):
        raise AssertionError(f"{name}: graph and eager greedy tokens differ "
                             f"in {len(prompts) - same} requests")
    return params


# ------------------------------------------------------- prefix phase
PREFIX_SYSTEM = 200        # tokens of the shared system prompt
PREFIX_POOL = 97           # prefix_evict's pool: idle cached pages must go
FRONTEND_DEADLINE = 8.0    # seconds of the front end's manual clock


def prefix_prompts(cfg, n=24):
    """``n`` prompts: one seeded 200-token system prompt, then a unique
    suffix of 16-96 tokens each (no two suffixes share a first token, so
    every hit matches the system prompt and no more)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 30)
    system = rng.integers(0, cfg.vocab_size, PREFIX_SYSTEM).tolist()
    return [system + rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(16, 97))).tolist()
            for _ in range(n)]


class ManualClock:
    """An injected clock: time moves only by ``advance``."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def check_graphs(name, eng):
    """The paged decode and prefill graphs, each captured once: the cache,
    the forks and the budget's partial chunks add no capture."""
    if (len(eng._graphs) != 2 or len(eng.timings["capture"]) != 2
            or any(g.graph is None for g in eng._graphs)):
        raise AssertionError(
            f"{name}: {len(eng.timings['capture'])} captures of "
            f"{len(eng._graphs)} graphs, wanted one of each of 2")


def first_difference(name, tok_a, tok_b):
    """Fail naming the first request and token where two runs differ."""
    for i, (a, b) in enumerate(zip(tok_a, tok_b)):
        if a != b:
            at = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                      min(len(a), len(b)))
            raise AssertionError(
                f"{name}: request {i} differs at new token {at}: "
                f"{a[at:at + 4]} against {b[at:at + 4]}")


def prefix_path(torch, dev, cfg, params, main_prompts, main_rec,
                main_tokens):
    """Phase ``prefix`` at ``main``'s configuration (on its params): the
    prefix cache cold against hot, and hot in a pool that must evict;
    the budget scheduler on ``main``'s prompts against ``main``'s tokens;
    the streaming front end over a hot engine."""
    prompts = prefix_prompts(cfg)
    n = len(prompts)
    runs = {}
    # request 0 alone until its prefill completes, then the other 23: a
    # request admitted with the first holder of the prefix would miss
    for name, kw in (("prefix_cold", {}),
                     ("prefix_hot", dict(prefix_cache=True)),
                     ("prefix_evict", dict(prefix_cache=True,
                                           n_pages=PREFIX_POOL))):
        eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                              serve_kw=dict(audit=2, **kw))
        runs[name] = serve(torch, name, eng, prompts, 32, first=1)
        check_graphs(name, eng)
        del eng
        torch.cuda.empty_cache()
    (cold, cold_tok), (hot, hot_tok), (evict, evict_tok) = (
        runs[k] for k in ("prefix_cold", "prefix_hot", "prefix_evict"))
    want = dict(hits=n - 1, misses=1, hit_tokens=(n - 1) * PREFIX_SYSTEM,
                cow_forks=n - 1)
    keys = ("seconds", "tok_s", "prefill_chunks", "prefill_chunk_ms",
            "prefill_chunk_ms_p50", "prefill_tok_s", "prefill_computed",
            "ttft_p50_ms", "ttft_p99_ms", "decode_step_ms",
            "decode_step_ms_p50", "capture_s", "audit_s", "peak_mem_gib",
            "preemptions")
    emit("prefix", model=cfg.name, layers=cfg.n_layers, requests=n,
         system_tokens=PREFIX_SYSTEM,
         prompt_tokens=sum(len(p) for p in prompts),
         identical_hot=sum(a == b for a, b in zip(cold_tok, hot_tok)),
         identical_evict=sum(a == b for a, b in zip(cold_tok, evict_tok)),
         evict_pool_pages=PREFIX_POOL,
         **{f"{k}_{run}": rec[k] for k in keys
            for run, rec in (("cold", cold), ("hot", hot),
                             ("evict", evict))},
         stats_hot=hot["prefix_stats"], stats_evict=evict["prefix_stats"])
    first_difference("prefix_hot", cold_tok, hot_tok)
    first_difference("prefix_evict", cold_tok, evict_tok)
    got = {k: hot["prefix_stats"][k] for k in want}
    if got != want:
        raise AssertionError(f"prefix_hot: stats {got}, wanted {want}")
    if hot["prefill_computed"] != cold["prefill_computed"] - want[
            "hit_tokens"]:
        raise AssertionError(
            f"prefix_hot: computed {hot['prefill_computed']} prefill "
            f"tokens, cold {cold['prefill_computed']}")
    if evict["prefix_stats"]["evicted_pages"] <= 0:
        raise AssertionError("prefix_evict: no cached page was evicted")

    budget_path(torch, dev, cfg, params, main_prompts, main_rec,
                main_tokens)
    frontend_path(torch, dev, cfg, params, prompts[:8], hot_tok[:8])
    return hot, hot_tok


def budget_path(torch, dev, cfg, params, prompts, main_rec, main_tokens):
    """``main``'s prompts under ``sched="budget"`` (the default 40 tokens
    a step: 8 lanes + one chunk), priorities alternating interactive and
    batch: ``main``'s tokens, and no step over the budget."""
    spend = {"prev": (0, 0), "max": 0, "steps": 0}

    def within_budget(eng, reqs):
        now = (eng.prefill_computed, sum(len(r.output) for r in reqs))
        spent = (now[0] - spend["prev"][0]) + (now[1] - spend["prev"][1])
        if spent > eng.sched.step_tokens:
            raise AssertionError(f"budget: step {spend['steps']} spent "
                                 f"{spent} > {eng.sched.step_tokens}")
        spend.update(prev=now, max=max(spend["max"], spent),
                     steps=spend["steps"] + 1)

    eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                          serve_kw=dict(sched="budget", audit=1))
    step_tokens = eng.sched.step_tokens
    if step_tokens != eng.n_slots + eng.prefill_chunk:
        raise AssertionError(f"budget: step_tokens {step_tokens}")
    prios = ["interactive", "batch"] * (len(prompts) // 2)
    rec, tokens = serve(torch, "budget", eng, prompts, 32,
                        priorities=prios, check_step=within_budget)
    check_graphs("budget", eng)
    del eng
    torch.cuda.empty_cache()
    keys = ("tok_s", "prefill_chunks", "prefill_chunk_ms",
            "prefill_chunk_ms_p50", "decode_steps", "decode_step_ms",
            "decode_step_ms_p50", "ttft_p50_ms", "ttft_p99_ms")
    emit("budget_vs_main", step_tokens=step_tokens, steps=spend["steps"],
         max_step_spend=spend["max"],
         identical_requests=sum(a == b for a, b in zip(tokens,
                                                       main_tokens)),
         **{f"{k}_budget": rec[k] for k in keys},
         **{f"{k}_main": main_rec[k] for k in keys})
    first_difference("budget", main_tokens, tokens)


def frontend_path(torch, dev, cfg, params, prompts, batch_tokens):
    """A ``ServeFrontend`` over a hot engine, on a manual clock that moves
    1 s a front-end step: stream 0 warms the cache, then 7 more; the one
    with the longest suffix is cancelled mid-prefill, the last times out.
    Streamed tokens equal ``prefix_hot``'s."""
    from repro_torch.serve import ServeFrontend

    clock = ManualClock()
    eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                          serve_kw=dict(prefix_cache=True, audit=2),
                          clock=clock)
    fe = ServeFrontend(eng, clock=clock)

    def step():
        live = fe.step()
        clock.advance(1.0)
        return live

    t0 = time.perf_counter()
    streams = [fe.submit(prompts[0])]
    while streams[0].state in ("queued", "prefilling"):
        step()
    victim = max(range(1, len(prompts) - 1), key=lambda i: len(prompts[i]))
    if len(prompts[victim]) - PREFIX_SYSTEM <= eng.prefill_chunk:
        raise AssertionError("frontend: no suffix outlasts one chunk")
    last = len(prompts) - 1
    streams += [fe.submit(p, deadline_s=FRONTEND_DEADLINE if i == last
                          else None)
                for i, p in enumerate(prompts[1:], 1)]
    step()
    req = streams[victim].req
    if streams[victim].state != "prefilling":
        raise AssertionError(f"frontend: stream {victim} is "
                             f"{streams[victim].state}, not prefilling")
    slot = eng.slot_req.index(req)
    held = len(eng.alloc._mapped[slot])
    refs = int(eng.alloc.refcount.sum())
    streams[victim].cancel()
    eng.audit()
    released = refs - int(eng.alloc.refcount.sum())
    if released != held or req in eng.slot_req:
        raise AssertionError(f"frontend: cancel released {released} of "
                             f"{held} page references")
    while step():
        pass
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    eng.audit()
    states = [s.state for s in streams]
    want = ["done"] * len(prompts)
    want[victim], want[last] = "cancelled", "timed_out"
    same = [s.tokens == t for s, t in zip(streams, batch_tokens)]
    timed = streams[last].tokens
    emit("frontend", streams=len(streams), states=states,
         identical_streams=sum(same), cancelled=victim, timed_out=last,
         timed_out_tokens=len(timed), timeout_count=fe.timeout_count,
         shed_count=fe.shed_count, seconds=seconds,
         new_tokens=sum(len(s.tokens) for s in streams),
         prefix_stats=eng.prefix_stats(),
         ttft_steps=[s.ttft() for s in streams])
    check_graphs("frontend", eng)
    if states != want or fe.timeout_count != 1:
        raise AssertionError(f"frontend: states {states}, wanted {want}")
    if streams[victim].tokens or not all(
            same[i] for i in range(len(streams)) if i not in (victim, last)):
        raise AssertionError(f"frontend: streamed tokens differ: {same}")
    if timed != batch_tokens[last][:len(timed)] or len(timed) >= 32:
        raise AssertionError("frontend: the timed-out stream's tokens")
    if int(eng.alloc.refcount.sum()) != 0:
        raise AssertionError("frontend: pages still referenced")
    del eng
    torch.cuda.empty_cache()


# ------------------------------------------------- obs and chaos phases
TRACE_PATH = ROOT / "chiprun_out" / "obs_trace.json"
CHAOS_RATES = {"page_grant": 0.05, "step_fault": 0.05, "nan_logits": 0.05,
               "preempt_storm": 0.02}
# the whole phase's bf16 logit tolerance, for the drill's near ties
CHAOS_LOGIT_TOL = 0.125


def _pct(values, q):
    import numpy as np

    return float(np.percentile(values, q)) if values else None


def _ms_pcts(values):
    """p50 and p99 of seconds, in ms."""
    return [None if v is None else 1e3 * v
            for v in (_pct(values, 50), _pct(values, 99))]


def _phase_seconds(events):
    """Host seconds of each step phase span (B/E pairs on the engine
    track) of a Chrome trace, by phase."""
    from repro_torch.obs.trace import ENGINE_TID

    out, open_at = {}, {}
    for ev in events:
        if ev.get("tid") != ENGINE_TID or ev["ph"] not in ("B", "E"):
            continue
        if ev["ph"] == "B":
            open_at[ev["name"]] = ev["ts"]
        else:
            out.setdefault(ev["name"], []).append(
                (ev["ts"] - open_at.pop(ev["name"])) / 1e6)
    return out


def obs_path(torch, dev, cfg, params, prompts, main_rec, main_tokens):
    """Phase ``obs``: ``main``'s configuration and 16 prompts with
    ``repro_torch.obs.enable(trace=True, annotations=True)``: ``main``'s
    tokens, tok/s beside ``main``'s with telemetry off, the host time of
    each step phase (from the trace's spans) and of each dispatch (the
    registry's histograms) beside the decode graph's replay time (CUDA
    events), TTFT / TPOT / queue wait from the timelines, and the cost
    ledger's modeled bytes and FLOPs of one decode step and one prefill
    chunk over their measured times: shares of the card's memory rate
    and bf16 peak.  The Chrome trace goes under ``chiprun_out/`` and is
    validated."""
    import repro_torch.obs as obs

    obs.enable(trace=True, annotations=True)
    try:
        eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params)
    finally:
        obs.disable()
    tel = eng.obs
    if not isinstance(tel, obs.Telemetry):
        raise AssertionError("obs: the engine has no live telemetry")
    step_fn, replays = eng._decode_paged, []

    def timed_step():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn()
        end.record()
        replays.append((start, end))
        return out

    eng._decode_paged = timed_step
    sample, sample_s = eng._sample_next, []

    def timed_sample(req):
        t0 = time.perf_counter()
        tok = sample(req)
        sample_s.append(time.perf_counter() - t0)
        return tok

    eng._sample_next = timed_sample
    rec, tokens = serve(torch, "obs_main", eng, prompts, 32)
    check_graphs("obs_main", eng)
    first_difference("obs_main", main_tokens, tokens)
    # the eager first call and the capture are not replays
    replay_ms = [s.elapsed_time(e) for s, e in replays[2:]]
    reg = tel.registry
    trace = tel.tracer.export()
    counts = obs.validate_trace(trace)
    TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
    tel.export_chrome_trace(str(TRACE_PATH))
    phases = _phase_seconds(trace["traceEvents"])
    tls = list(tel.timelines.values())
    dec_tab = obs.total_cost(eng._decode_cost_table)
    pf_tab = obs.total_cost(eng._prefill_cost_table)
    dec_s, pf_s = eng.timings["decode"], eng.timings["prefill"]
    led = tel.costs.snapshot()
    # every dispatch was charged: the ledger is the tables times the steps
    want_flops = dec_tab.flops * len(dec_s) + pf_tab.flops * len(pf_s)
    if not math.isclose(led["total_flops"], want_flops, rel_tol=1e-9):
        raise AssertionError(f"obs: ledger {led['total_flops']} FLOPs, "
                             f"tables x steps {want_flops}")

    def shares(cost, seconds):
        t = dict(mean=sum(seconds) / len(seconds), p50=_pct(seconds, 50))
        return {k: dict(hbm=cost.bytes / (v * PEAK_HBM_BYTES_S),
                        mfu=cost.flops / (v * PEAK_OPS_S["bfloat16"]))
                for k, v in t.items()}

    dec_share = shares(dec_tab, dec_s)
    replay_share = shares(dec_tab, [ms / 1e3 for ms in replay_ms])
    pf_share = shares(pf_tab, pf_s)
    hist = {name: reg.histogram(name).to_dict() for name in (
        "serve_step_s", "serve_prefill_chunk_s", "serve_decode_step_s")}
    out = dict(
        requests=len(prompts), identical_requests=sum(
            a == b for a, b in zip(main_tokens, tokens)),
        tok_s_obs=rec["tok_s"], tok_s_main=main_rec["tok_s"],
        tok_s_ratio=rec["tok_s"] / main_rec["tok_s"],
        decode_steps=len(dec_s), prefill_chunks=len(pf_s),
        graphs_captured=rec["graphs_captured"],
        steps=tel.snapshot()["steps"],
        phase_ms_p50_p99={name: _ms_pcts(v) for name, v in phases.items()},
        phase_ms_mean={name: 1e3 * sum(v) / len(v)
                       for name, v in phases.items()},
        registry_ms_p50_p99={name: [None if h[q] is None else 1e3 * h[q]
                                    for q in ("p50", "p99")]
                             for name, h in hist.items()},
        sample_ms_per_decode_step=1e3 * sum(sample_s) / len(dec_s),
        decode_step_ms_mean=1e3 * sum(dec_s) / len(dec_s),
        decode_step_ms_p50=1e3 * _pct(dec_s, 50),
        replay_ms_mean=sum(replay_ms) / len(replay_ms),
        replay_ms_p50=_pct(replay_ms, 50), replays=len(replay_ms),
        prefill_chunk_ms_mean=1e3 * sum(pf_s) / len(pf_s),
        prefill_chunk_ms_p50=1e3 * _pct(pf_s, 50),
        ttft_ms_p50_p99=_ms_pcts([t.ttft for t in tls]),
        tpot_ms_p50_p99=_ms_pcts([t.tpot for t in tls]),
        queue_wait_ms_p50_p99=_ms_pcts([t.queue_wait for t in tls]),
        decode_step_bytes=dec_tab.bytes, decode_step_flops=dec_tab.flops,
        prefill_chunk_bytes=pf_tab.bytes, prefill_chunk_flops=pf_tab.flops,
        decode_bytes_by_op={op: c.bytes for op, c
                            in eng._decode_cost_table.items()},
        decode_hbm_roofline_share_mean=dec_share["mean"]["hbm"],
        decode_hbm_roofline_share_p50=dec_share["p50"]["hbm"],
        decode_hbm_roofline_share_replay_mean=replay_share["mean"]["hbm"],
        decode_mfu_mean=dec_share["mean"]["mfu"],
        prefill_mfu_mean=pf_share["mean"]["mfu"],
        prefill_mfu_p50=pf_share["p50"]["mfu"],
        prefill_hbm_roofline_share_mean=pf_share["mean"]["hbm"],
        prefill_hbm_roofline_share_p50=pf_share["p50"]["hbm"],
        ledger_total_bytes=led["total_bytes"],
        ledger_total_flops=led["total_flops"],
        trace_events=len(trace["traceEvents"]),
        trace_dropped=trace["otherData"]["dropped_events"],
        trace_tracks=len(counts), trace_file=str(TRACE_PATH),
        prometheus_chars=len(tel.prometheus_text()),
        request_states=tel.snapshot()["request_states"])
    emit("obs", **out)
    if out["identical_requests"] != len(prompts):
        raise AssertionError("obs: tokens differ from main's")
    if out["request_states"] != {"retired": len(prompts)}:
        raise AssertionError(f"obs: states {out['request_states']}")
    if min(len(phases.get(p, ())) for p in ("admit", "prefill",
                                             "decode")) == 0:
        raise AssertionError(f"obs: phases {sorted(phases)}")
    del eng
    torch.cuda.empty_cache()
    return out


def chaos_path(torch, dev, cfg, params, hot_rec, hot_tok):
    """Phase ``chaos``: ``prefix_hot``'s 24 shared-prompt requests on a hot
    engine at ``audit=2`` under ``ChaosInjector(seed=0, CHAOS_RATES)`` and
    a retry budget of 5: every site fired, retries and no quarantine,
    wasted FLOPs in the ledger, every audit passed, two captures, and
    ``prefix_hot``'s tokens up to a near tie.  A request that was never
    retried or preempted must give ``prefix_hot``'s tokens exactly.  A
    retried or preempted one recomputes its K/V by prefill, where
    ``prefix_hot`` computed the generated tokens' K/V by decode steps: the
    two GEMV routes and attention kernels sum in other orders, and a bf16
    or int8 rounding may fall the other way, so where it first differs
    from ``prefix_hot``, ``prefix_hot``'s token must be among the drill's
    top 8 candidates and within ``2 * CHAOS_LOGIT_TOL`` of its best
    logit (the ``whole`` phase's rule).  Then a quarantine through ``ServeFrontend``
    (``nan_logits`` at its third check, no retry budget) over 8 short
    prompts: one stream in ``error``, the others equal to a clean run's,
    the quarantined lane's pages zero on the card, the trace valid."""
    import numpy as np

    import repro_torch.obs as obs
    from repro_torch.ft import ChaosInjector

    prompts = prefix_prompts(cfg)
    chaos = ChaosInjector(seed=0, rates=CHAOS_RATES)
    obs.enable(trace=True)
    try:
        eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                              chaos=chaos,
                              serve_kw=dict(audit=2, prefix_cache=True,
                                            max_request_retries=5))
    finally:
        obs.disable()
    reqs, top = [], {}
    submit, sample = eng.submit, eng._sample_next

    def recording_submit(*args, **kwargs):
        reqs.append(submit(*args, **kwargs))
        return reqs[-1]

    def recording_sample(req):
        lg = np.asarray(req.last_logits, np.float32).reshape(-1)
        idx = np.argpartition(lg, -8)[-8:]
        top[req.rid, len(req.output)] = dict(zip(idx.tolist(),
                                                 lg[idx].tolist()))
        return sample(req)

    eng.submit, eng._sample_next = recording_submit, recording_sample
    rec, tokens = serve(torch, "chaos_drill", eng, prompts, 32, first=1)
    check_graphs("chaos_drill", eng)
    ties = []
    for r, want, got in zip(reqs, hot_tok, tokens):
        if want == got:
            continue
        i = next(j for j, (a, b) in enumerate(zip(want, got)) if a != b)
        cand = top[r.rid, i]
        margin = (cand[got[i]] - cand[want[i]] if want[i] in cand
                  else math.inf)
        ties.append(dict(request=r.rid, token=i, margin=margin,
                         retries=r.retries, preemptions=r.preemptions,
                         best_logit=cand[got[i]]))
    m = eng.metrics()
    counters = m["obs"]["metrics"]["counters"]
    fired = chaos.summary()
    drill = dict(
        requests=len(prompts), rates=CHAOS_RATES, fired=fired,
        identical_requests=sum(a == b for a, b in zip(hot_tok, tokens)),
        recomputed_requests=sum(bool(r.retries or r.preemptions)
                                for r in reqs),
        near_tie_divergences=ties, logit_tol=CHAOS_LOGIT_TOL,
        retried=eng.retried, quarantined=eng.quarantined,
        preemptions=eng.preemptions, tok_s=rec["tok_s"],
        tok_s_hot=hot_rec["tok_s"], tok_s_ratio=rec["tok_s"]
        / hot_rec["tok_s"], prefill_chunks=rec["prefill_chunks"],
        decode_steps=rec["decode_steps"],
        prefill_computed=rec["prefill_computed"],
        prefill_computed_hot=hot_rec["prefill_computed"],
        wasted_flops=m["costs"]["wasted_flops"],
        wasted_bytes=m["costs"]["wasted_bytes"],
        total_flops=m["costs"]["total_flops"],
        audits=counters.get("serve_audits_total", 0),
        audit_failures=counters.get("serve_audit_failures_total", 0),
        graphs_captured=rec["graphs_captured"],
        trace_events=len(eng.obs.tracer.events))
    obs.validate_trace(eng.obs.tracer.export())
    emit("chaos_drill", **drill)
    bad = [t for t in ties if not (t["retries"] or t["preemptions"])
           or t["margin"] > 2 * CHAOS_LOGIT_TOL]
    if bad:
        raise AssertionError(f"chaos: tokens differ from prefix_hot's "
                             f"beyond a near tie: {bad}")
    missing = [s for s in CHAOS_RATES if not fired.get(s)]
    if missing or not eng.retried or eng.quarantined:
        raise AssertionError(f"chaos: sites never fired {missing}, "
                             f"{eng.retried} retries, {eng.quarantined} "
                             "quarantines")
    if not drill["wasted_flops"] > 0 or not drill["audits"] or drill[
            "audit_failures"]:
        raise AssertionError(f"chaos: ledger / audits {drill}")
    del eng
    torch.cuda.empty_cache()
    quarantine_path(torch, dev, cfg, params)


def quarantine_path(torch, dev, cfg, params):
    """8 short prompts through ``ServeFrontend``: once clean, once under
    ``nan_logits`` at its third check (a decode step: every prompt fits
    one chunk) with no retry budget.  The quarantined lane's private
    pages are read back on the card right after the scrub."""
    import repro_torch.obs as obs
    from repro_torch.ft import ChaosInjector
    from repro_torch.serve import ServeFrontend

    prompts = prompts_for(cfg, 8, 8, 32, SEED + 40)
    streams, scrubbed = {}, []
    for name, chaos in (("clean", None), ("quarantine", ChaosInjector(
            seed=0, schedule={"nan_logits": {2}}))):
        obs.enable(trace=True)
        try:
            eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                                  chaos=chaos, serve_kw=dict(
                                      audit=2, max_request_retries=0))
        finally:
            obs.disable()
        quarantine = eng._quarantine

        def watched(slot, req, kind, eng=eng, quarantine=quarantine):
            private = [p for p in eng.alloc._mapped[slot]
                       if eng.alloc.refcount[p] == 1]
            quarantine(slot, req, kind)
            idx = torch.tensor(private, device=dev)
            torch.cuda.synchronize()
            nonzero = sum(int(torch.count_nonzero(t[:, idx])) for t in (
                eng.pages.k, eng.pages.v, eng.pages.k_scale,
                eng.pages.v_scale) if t is not None)
            scrubbed.append(dict(rid=req.rid, pages=len(private),
                                 nonzero_after_scrub=nonzero))

        eng._quarantine = watched
        fe = ServeFrontend(eng)
        got = [fe.submit(p) for p in prompts]
        fe.drain()
        torch.cuda.synchronize()
        eng.audit()
        obs.validate_trace(eng.obs.tracer.export())
        streams[name] = [(s.state, s.tokens) for s in got]
        # every prompt fits one chunk: only the decode step is captured
        if eng.timings["capture"] == [] or eng._graphs[0].graph is None:
            raise AssertionError(f"quarantine_{name}: the decode step "
                                 "was not captured")
        del eng, fe
        torch.cuda.empty_cache()
    states = [s for s, _ in streams["quarantine"]]
    same = [i for i, ((s, t), (_, c)) in enumerate(
        zip(streams["quarantine"], streams["clean"])) if s != "error"
        and t == c]
    emit("quarantine", streams=len(prompts), states=states,
         identical_other_streams=len(same), scrubbed=scrubbed,
         clean_states=[s for s, _ in streams["clean"]])
    if states.count("error") != 1 or len(same) != len(prompts) - 1:
        raise AssertionError(f"quarantine: states {states}, {len(same)} "
                             "other streams equal the clean run's")
    if len(scrubbed) != 1 or scrubbed[0]["pages"] == 0 or scrubbed[0][
            "nonzero_after_scrub"]:
        raise AssertionError(f"quarantine: scrub {scrubbed}")


# ------------------------------------------- snapshot and dense phases
SNAPSHOT_DIR = ROOT / "build" / "snapshots"


def _restart_point(eng):
    """A kill point worth restoring from: some request has decoded, some
    lane is still in its chunked prefill and some request still queues."""
    lanes = [r for r in eng.slot_req if r is not None]
    return (any(len(r.output) >= 2 for r in lanes) and eng.queue
            and any(r.prefill_pos < len(r.prefill_tokens) for r in lanes))


def _drive(eng, prompts, first, until=None, limit=5000):
    """Submit ``first`` prompts, the rest once those have their first
    logits (``serve()``'s ``first``), and step until ``until(eng)`` holds
    after a step (None: until the engine drains).  Returns the requests
    submitted and the steps taken."""
    reqs = [eng.submit(p) for p in prompts[:first]]
    steps = 0
    while eng.has_work() or len(reqs) < len(prompts):
        if len(reqs) < len(prompts) and all(r.last_logits is not None
                                            for r in reqs):
            reqs += [eng.submit(p) for p in prompts[first:]]
        eng.step()
        steps += 1
        if until is not None and until(eng):
            return reqs, steps
        if steps > limit:
            raise AssertionError("snapshot: the engine did not drain")
    if until is not None:
        raise AssertionError("snapshot: no restart point was reached")
    return reqs, steps


def _recording_top(eng):
    """Record the top 8 logits of every sampling step of ``eng`` by
    (rid, token index), for the near-tie rule: of the logits sampled (the
    audio family's ``(K, V)`` logits sample codebook 0)."""
    import numpy as np

    top, sample = {}, eng._sample_next

    def recording(req):
        lg = np.asarray(req.last_logits, np.float32)
        lg = lg[0] if lg.ndim == 2 else lg.reshape(-1)
        idx = np.argpartition(lg, -8)[-8:]
        top[req.rid, len(req.output)] = dict(zip(idx.tolist(),
                                                 lg[idx].tolist()))
        return sample(req)

    eng._sample_next = recording
    return top


def _finish(name, eng, n_req, max_new):
    """Run a restored engine to the end: every in-flight request done
    with ``max_new`` tokens and finite logits; its tokens by rid."""
    import numpy as np

    done = eng.run()
    if len(done) != n_req:
        raise AssertionError(f"{name}: {len(done)} of {n_req} finished")
    for r in done:
        if not r.done or len(r.output) != max_new or r.retries or (
                r.last_logits is None
                or not np.isfinite(r.last_logits).all()):
            raise AssertionError(f"{name}: request {r.rid} done={r.done} "
                                 f"with {len(r.output)} tokens")
    return {r.rid: r.output for r in done}


def near_ties(name, want, got, top):
    """Greedy tokens of a run (``got`` by rid) against a reference
    (``want`` by rid): exact, or up to a near tie by the ``whole`` /
    ``chaos`` phases' rule (at the first difference the reference's token
    is among the run's top 8 and within ``2 * CHAOS_LOGIT_TOL`` of its
    best logit).  Returns the differing requests, named; raises past a
    near tie."""
    ties = []
    for rid, w in sorted(want.items()):
        g = got[rid]
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        cand = top[rid, i]
        margin = (cand[g[i]] - cand[w[i]] if w[i] in cand else math.inf)
        ties.append(dict(request=rid, token=i, margin=margin,
                         best_logit=cand[g[i]]))
    bad = [t for t in ties if t["margin"] > 2 * CHAOS_LOGIT_TOL]
    if bad:
        raise AssertionError(f"{name}: tokens differ beyond a near tie: "
                             f"{bad}")
    return ties


def kill_and_restore(torch, dev, name, cfg, params, prompts, want_tokens,
                     *, first, serve_kw=None, want_stats=None):
    """The recovery drill on the card.  Engine A runs ``prompts`` to the
    first restart point (step k: requests decoding, lanes mid-prefill,
    requests queued) and saves a snapshot to disk (``save_snapshot``);
    A runs on to the end (its tokens: ``want_tokens``).  A fresh engine
    on the same params loads the snapshot (``load_snapshot``) and runs to
    the end; then A itself, with both step graphs captured, restores the
    in-memory snapshot (``restore``, in place: no new capture, the pool at
    the same addresses) and runs to the end once more.  A restore
    recomputes nothing, so the tokens must equal ``want_tokens`` exactly;
    a difference within a near tie is reported, by request, as a
    finding."""
    from repro_torch.ckpt import checkpoint as ckpt

    max_new = 32
    eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                          serve_kw=serve_kw)
    reqs, k = _drive(eng, prompts, first, until=_restart_point)
    lanes = [r for r in eng.slot_req if r is not None]
    state = dict(k=k, queued=len(eng.queue),
                 prefilling=sum(r.prefill_pos < len(r.prefill_tokens)
                                for r in lanes),
                 decoding=sum(bool(r.output) for r in lanes),
                 tokens_out=sum(len(r.output) for r in reqs))
    stats_at_k = eng.prefix_stats()
    directory = SNAPSHOT_DIR / name
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = eng.snapshot()
    snapshot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.save_snapshot(str(directory), k)
    save_s = time.perf_counter() - t0
    manifest = ckpt.read_manifest(str(directory), k)
    n_bytes = {leaf["path"]: leaf["nbytes"] for leaf in manifest["leaves"]}
    shard = directory / f"step_{k:08d}" / "shard_0.bin"
    # A runs on to the end: the uninterrupted run
    while eng.has_work():
        eng.step()
    a_tokens = {r.rid: r.output for r in reqs}
    first_difference(f"{name}_uninterrupted",
                     [want_tokens[r.rid] for r in reqs],
                     [a_tokens[r.rid] for r in reqs])
    check_graphs(f"{name}_uninterrupted", eng)
    in_flight = len(snap["host"]["requests"])

    fresh, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                            serve_kw=serve_kw)
    top_fresh = _recording_top(fresh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.load_snapshot(str(directory))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    stats_loaded = fresh.prefix_stats()
    got_fresh = _finish(f"{name}_fresh", fresh, in_flight, max_new)
    check_graphs(f"{name}_fresh", fresh)
    stats_fresh = fresh.prefix_stats()
    del fresh
    torch.cuda.empty_cache()

    pools = {n: t.data_ptr() for n, t in eng._pool_tensors().items()}
    lanes_ptr = {n: t.data_ptr() for n, t in vars(eng.lanes).items()}
    captures = len(eng.timings["capture"])
    top_in_place = _recording_top(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore(snap)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got_in_place = _finish(f"{name}_in_place", eng, in_flight, max_new)
    same_ptrs = (pools == {n: t.data_ptr()
                           for n, t in eng._pool_tensors().items()}
                 and lanes_ptr == {n: t.data_ptr()
                                   for n, t in vars(eng.lanes).items()})
    new_captures = len(eng.timings["capture"]) - captures
    want = {rid: want_tokens[rid] for rid in got_fresh}
    ties_fresh = near_ties(f"{name}_fresh", want, got_fresh, top_fresh)
    ties_in_place = near_ties(f"{name}_in_place", want, got_in_place,
                              top_in_place)
    rec = dict(
        model=cfg.name, layers=cfg.n_layers, requests=len(prompts),
        restart_point=state, in_flight=in_flight,
        codec=manifest["codec"],
        snapshot_bytes=sum(n_bytes.values()),
        pool_bytes=sum(v for p, v in n_bytes.items()
                       if p.startswith("pages/")),
        logits_bytes=sum(v for p, v in n_bytes.items()
                         if p.startswith("logits/")),
        shard_file_bytes=shard.stat().st_size,
        snapshot_s=snapshot_s, save_s=save_s, load_s=load_s,
        restore_in_place_s=restore_s,
        exact_fresh=sum(got_fresh[r] == want[r] for r in want),
        exact_in_place=sum(got_in_place[r] == want[r] for r in want),
        near_ties_fresh=ties_fresh, near_ties_in_place=ties_in_place,
        in_place_new_captures=new_captures,
        in_place_same_addresses=same_ptrs,
        prefix_stats_at_k=stats_at_k, prefix_stats_loaded=stats_loaded,
        prefix_stats_end=stats_fresh, prefix_stats_want=want_stats)
    emit(name, **rec)
    shutil.rmtree(directory, ignore_errors=True)
    if new_captures or not same_ptrs:
        raise AssertionError(f"{name}: the in-place restore captured "
                             f"{new_captures} graphs, same addresses "
                             f"{same_ptrs}")
    check_graphs(f"{name}_in_place", eng)
    if stats_loaded != stats_at_k or (want_stats is not None
                                      and stats_fresh != want_stats):
        raise AssertionError(f"{name}: prefix stats {stats_loaded} at load "
                             f"({stats_at_k} at k), {stats_fresh} at the "
                             f"end ({want_stats} wanted)")
    del eng
    torch.cuda.empty_cache()
    return rec


def snapshot_path(torch, dev, cfg, params, main_prompts, main_tokens,
                  hot_rec, hot_tok):
    """Phase ``snapshot``: the recovery drill (``kill_and_restore``) on
    ``main``'s 16 prompts and on ``prefix_hot``'s traffic (the cache's
    tree restored, its hit counters going on from the snapshot's to
    ``prefix_hot``'s)."""
    main = kill_and_restore(torch, dev, "snapshot_main", cfg, params,
                            main_prompts, dict(enumerate(main_tokens)),
                            first=len(main_prompts))
    hot = kill_and_restore(torch, dev, "snapshot_prefix_hot", cfg, params,
                           prefix_prompts(cfg), dict(enumerate(hot_tok)),
                           first=1, serve_kw=dict(prefix_cache=True,
                                                  audit=2),
                           want_stats=hot_rec["prefix_stats"])
    return main, hot


# the dense configs served on the card: (arch, depth cut, prompts (n, lo,
# hi), max_len).  gemma3's prompts pass its 1024-token window;
# mistral-large at 8 of its 88 layers (its 4-bit codes at 88 layers are
# about 61 GB)
# starcoder2-15b cut to 20 of 40 layers and gemma3-27b to 16 of 62 (2
# global), for phase ``launch``'s time (PERF.md §4)
DENSE_CASES = [("starcoder2-15b", 20, (16, 33, 300), 1024),
               ("gemma3-27b", 16, (8, 1100, 1900), 2048),
               ("mistral-large-123b", 8, (16, 33, 300), 1024)]


def arch_config(arch, n_layers=None, **changes):
    from repro_torch.config import get_arch

    cfg = get_arch(arch)
    if n_layers is not None:
        changes["n_layers"] = n_layers
    return dataclasses.replace(cfg, **changes)


def decode_bytes_share(eng, rec):
    """The cost ledger's bytes of one decode step of ``eng`` (its tables,
    as the engine charges them) over the measured mean and p50 step, as
    shares of 3.35 TB/s."""
    import repro_torch.obs as obs

    table = obs.decode_step_costs(
        obs.model_dims(eng.cfg), batch=eng.n_slots,
        context=eng._max_blocks * eng.page_size, page_size=eng.page_size,
        attn_backend=eng.attn_backend, kv_bits=eng.kv_bits,
        specs=obs.linear_specs(eng.params))
    n_bytes = obs.total_cost(table).bytes
    return dict(
        decode_step_bytes=n_bytes,
        decode_bound_ms=1e3 * n_bytes / PEAK_HBM_BYTES_S,
        decode_hbm_roofline_share_mean=n_bytes / (
            rec["decode_step_ms"] / 1e3 * PEAK_HBM_BYTES_S),
        decode_hbm_roofline_share_p50=n_bytes / (
            rec["decode_step_ms_p50"] / 1e3 * PEAK_HBM_BYTES_S))


def dense_path(torch, dev):
    """Phase ``dense``: each of ``DENSE_CASES`` served paged at
    ``weight_bits=4, kv_bits=8``, 8 lanes, page 16, chunk 32, with the
    step graphs (tok/s, step and chunk ms, peak memory, launches by route,
    the ledger's decode bytes share), then eagerly (identical tokens),
    then at 2 layers against the plain-backend engine (``whole``'s check;
    gemma3 with one local and one global layer, prompts past the
    window)."""
    out = {}
    for arch, depth, (n, lo, hi), max_len in DENSE_CASES:
        cfg = arch_config(arch, depth)
        prompts = prompts_for(cfg, n, lo, hi, SEED + 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, params = build_engine(torch, dev, cfg, 4, 8, max_len=max_len)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        name = f"dense_{arch}"
        rec, tokens = serve(torch, name, eng, prompts, 32)
        check_graphs(name, eng)
        share = decode_bytes_share(eng, rec)
        windows = sorted({0 if cfg.is_global_layer(i) else
                          cfg.sliding_window for i in range(cfg.n_layers)})
        routes = {k: route_counts(k, rec["route_launches"])
                  for k in ("bitplane_gemv", "paged_prefill_attention")}
        routes["paged_decode_attention"] = rec["launches"][
            "paged_decode_attention"]
        out[arch] = dict(
            model=cfg.name, layers=cfg.n_layers,
            layers_published=arch_config(arch).n_layers,
            depth_cut=(f"{arch_config(arch).n_layers} -> {cfg.n_layers} "
                       "layers" if depth else None),
            d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
            group=cfg.n_heads // cfg.n_kv_heads, d_ff=cfg.d_ff,
            vocab=cfg.vocab_size, mlp_gated=cfg.mlp_gated,
            tied=cfg.tie_embeddings, windows=windows, max_len=max_len,
            prompts=[n, lo, hi], init_s=init_s,
            **{k: rec[k] for k in (
                "tok_s", "decode_steps", "decode_step_ms",
                "decode_step_ms_p50", "prefill_chunks", "prefill_chunk_ms",
                "prefill_chunk_ms_p50", "prefill_tok_s", "peak_mem_gib",
                "capture_s", "launches")},
            routes=routes, **share)
        emit(f"{name}_summary", **out[arch])
        if min(rec["launches"][k] for k in PAGED_KERNELS) == 0:
            raise AssertionError(f"{name}: launches {rec['launches']}")
        del eng
        torch.cuda.empty_cache()
        graphs_against_eager(torch, dev, name, cfg, 4, 8, prompts, 32,
                             params=params, graph_rec=rec,
                             graph_tokens=tokens, max_len=max_len)
        del params
        torch.cuda.empty_cache()
        # two layers at full width against the plain path
        two = (arch_config(arch, 2, global_every=2) if cfg.sliding_window
               else arch_config(arch, 2))
        whole_path_check(torch, dev, cfg=two, max_len=max_len,
                         prompts=prompts_for(two, 8, lo, hi, SEED + 51),
                         name=f"{name}_whole")
        torch.cuda.empty_cache()
    return out


def routed_bytes_share(eng, rec, ledger):
    """The ledger's decode step with its stacked expert linears priced for
    the experts the run's decode steps touched (mean over steps, summed
    over layers: ``eng.experts_touched``) in place of every expert, over
    the measured mean and p50 step, as shares of 3.35 TB/s."""
    import numpy as np

    import repro_torch.obs as obs

    touched = eng.experts_touched["decode"]
    specs = obs.linear_specs(eng.params)
    table = obs.decode_step_costs(
        obs.model_dims(eng.cfg), batch=eng.n_slots,
        context=eng._max_blocks * eng.page_size, page_size=eng.page_size,
        attn_backend=eng.attn_backend, kv_bits=eng.kv_bits, specs=specs)
    mean_touched = float(np.mean(touched))
    n_bytes = obs.total_cost(obs.routed_costs(table, specs,
                                              touched=mean_touched)).bytes
    if abs(obs.total_cost(table).bytes - ledger["decode_step_bytes"]) > 1:
        raise AssertionError("routed_bytes_share: not the ledger's table")
    share = dict(
        experts_touched_per_step_mean=mean_touched,
        experts_touched_per_layer_mean=mean_touched / eng.cfg.n_layers,
        experts_per_layer=eng.cfg.n_experts,
        routed_decode_step_bytes=n_bytes,
        routed_decode_bound_ms=1e3 * n_bytes / PEAK_HBM_BYTES_S,
        routed_hbm_roofline_share_mean=n_bytes / (
            rec["decode_step_ms"] / 1e3 * PEAK_HBM_BYTES_S),
        routed_hbm_roofline_share_p50=n_bytes / (
            rec["decode_step_ms_p50"] / 1e3 * PEAK_HBM_BYTES_S))
    if share["routed_hbm_roofline_share_mean"] > 1:
        raise AssertionError(f"routed bytes share above 1: {share}")
    return share


def moe_path(torch, dev):
    """Phase ``moe``: each of ``MOE_CASES`` served paged with ``main``'s
    setup (``weight_bits=4, kv_bits=8``, 8 lanes, max_len 1024, page 16,
    chunk 32, 16 prompts of 33-300 tokens, 32 new tokens each) with the
    step graphs: tok/s, step and chunk ms, init seconds, peak memory,
    launches by route (the grouped routes above 0), the ledger's decode
    bytes share (every expert priced, as the JAX package's ledger prices
    them) and the routed one (the experts the steps touched); then
    eagerly (identical tokens); then at 2 layers in float32 with float32
    pages against the plain-backend engine (``whole``'s check).  Returns
    each case's record."""
    out = {}
    for arch, depth in MOE_CASES:
        cfg = arch_config(arch, depth)
        prompts = prompts_for(cfg, 16, 33, 300, SEED + 60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, params = build_engine(torch, dev, cfg, 4, 8)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        name = f"moe_{arch}"
        rec, tokens = serve(torch, name, eng, prompts, 32)
        check_graphs(name, eng)
        ledger = decode_bytes_share(eng, rec)
        routed = routed_bytes_share(eng, rec, ledger)
        chunks_touched = eng.experts_touched["prefill"]
        routed["experts_touched_per_chunk_mean"] = (
            sum(chunks_touched) / max(len(chunks_touched), 1))
        # where a decode step's device time goes: 8 more prompts, four
        # decode-only steps and two chunks profiled (replays)
        prof = profile_decode_steps(
            torch, eng, prompts_for(cfg, 8, 33, 300, SEED + 62),
            name=f"{name}_profile")
        routes = {k: route_counts(k, rec["route_launches"])
                  for k in ("bitplane_gemv", "paged_prefill_attention")}
        routes["paged_decode_attention"] = rec["launches"][
            "paged_decode_attention"]
        grouped = {r: v for r, v in routes["bitplane_gemv"].items()
                   if r.startswith("grouped_")}
        if not (grouped["grouped_decode"] and grouped["grouped_tensor_core"]):
            raise AssertionError(f"{name}: grouped routes {grouped}")
        out[arch] = dict(
            model=cfg.name, layers=cfg.n_layers,
            layers_published=arch_config(arch).n_layers,
            depth_cut=(f"{arch_config(arch).n_layers} -> {cfg.n_layers} "
                       "layers" if depth else None),
            d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
            experts=cfg.n_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
            shared_experts=cfg.n_shared_experts, vocab=cfg.vocab_size,
            prompts=[16, 33, 300], init_s=init_s,
            **{k: rec[k] for k in (
                "tok_s", "decode_steps", "decode_step_ms",
                "decode_step_ms_p50", "prefill_chunks", "prefill_chunk_ms",
                "prefill_chunk_ms_p50", "prefill_tok_s", "peak_mem_gib",
                "capture_s", "launches", "gemv_grouped_decode_launches",
                "gemv_grouped_tensor_core_launches")},
            routes=routes, grouped_routes=grouped,
            ledger_bytes_note="every expert of every layer priced, as "
                              "the JAX package's ledger prices them",
            **ledger, **routed,
            **{f"profile_{k}": prof.get(k) for k in (
                "replay_ms", "replay_share", "step_wall_ms",
                "device_kernel_ms_per_step", "device_busy_share",
                "port_kernels_ms_per_step")})
        emit(f"{name}_summary", **out[arch])
        if min(rec["launches"][k] for k in PAGED_KERNELS) == 0:
            raise AssertionError(f"{name}: launches {rec['launches']}")
        del eng
        torch.cuda.empty_cache()
        graphs_against_eager(torch, dev, name, cfg, 4, 8, prompts, 32,
                             params=params, graph_rec=rec,
                             graph_tokens=tokens)
        del params
        torch.cuda.empty_cache()
        # two layers at full width against the plain path, in float32 with
        # float32 pages: top-k routing is discontinuous, and with bf16
        # activations, or the bf16 roundings of int8 pages, the two paths
        # differ by enough to reroute a token at a router near-tie
        # (qwen3-moe's 8th and 9th of 128 experts; PERF.md); in
        # float32 throughout they route alike, and the near-tie rule holds
        # the rest of the path
        two = arch_config(arch, 2, dtype="float32")
        whole_path_check(torch, dev, cfg=two,
                         prompts=prompts_for(two, 8, 33, 300, SEED + 61),
                         name=f"{name}_whole", kv_bits=0)
        torch.cuda.empty_cache()
    return out


# phase families: the paged two (arch, image positions of the full-sequence
# prompts or 0), each at its published depth
# (arch, image positions, layers): depth cut to keep the whole run inside
# its time with phase ``launch`` (PERF.md §4)
FAMILY_PAGED = [("llava-next-mistral-7b", 2880, 16),
                ("musicgen-medium", 0, 24)]
HYBRID = "zamba2-7b"
FAMILY_HYBRID_LAYERS = 42          # 7 of 13 shared-attention sites
# the vlm full-sequence prompts: image positions + text tokens = 4096
VLM_TEXT_TOKENS = 1216


def family_summary(eng, rec, init_s, **more):
    """A served model's record: tok/s, step and chunk ms (mean and p50),
    peak memory, init seconds and launches by route of every kernel."""
    cfg = eng.cfg
    return dict(
        model=cfg.name, family=cfg.family, mode=eng.mode,
        layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        vocab=cfg.vocab_size, codebooks=cfg.n_codebooks, init_s=init_s,
        **{k: rec[k] for k in (
            "requests", "prompt_tokens", "tok_s", "decode_steps",
            "decode_step_ms", "decode_step_ms_p50", "prefill_chunks",
            "prefill_chunk_ms", "prefill_chunk_ms_p50", "prefill_tok_s",
            "peak_mem_gib", "capture_s", "launches")},
        routes={k: route_counts(k, rec["route_launches"])
                for k in ("bitplane_gemv", "paged_prefill_attention",
                          "flash_attention")},
        **more)


def sequence_summary(rec):
    """A full-sequence run's prefill and decode figures and launches."""
    return {f"sequence_{k}": rec[k] for k in (
        "batch", "prompt_tokens", "image_positions", "prefill_s",
        "prefill_tok_s", "decode_steps", "decode_step_ms",
        "decode_step_ms_p50", "decode_tok_s", "peak_mem_gib",
        "prefill_launches", "decode_launches", "prefill_gemv_routes",
        "decode_gemv_routes", "prefill_flash_routes")}


def families_path(torch, dev):
    """Phase ``families``: the vlm, audio and hybrid configs at published
    widths, depth cut (``FAMILY_PAGED``, ``FAMILY_HYBRID_LAYERS``), 4-bit
    weights, random weights from the seed.

    * llava-next-mistral-7b (16 of 32 layers) and musicgen-medium (24 of
      48 layers, four codebooks, each prompt id broadcast over them) served
      paged at
      ``kv_bits=8`` with ``main``'s setup (8 lanes, page 16, chunk 32, 16
      text prompts of 33-300 tokens, 32 new tokens each): graphs, then
      eager (identical tokens), the ledger's decode bytes share, then at 2
      layers against the plain backends (``whole``'s check);
    * llava's full-sequence path: ``prefill`` of 2 prompts of 2880 seeded
      image positions and 1216 tokens (4096 positions: flash attention),
      16 ``decode_step`` s; at 2 layers against the plain path and
      ``forward`` (``long_whole``'s check);
    * zamba2-7b (42 of 81 layers, 7 shared-attention sites) in slots mode at
      ``kv_bits=0``: 8 slots, max_len 1024, 8 prompts of 17-64 tokens by
      sequential decode, 16 new tokens each; graphs against eager at 12
      layers (two sites); the full-sequence path, ``prefill`` of 2 x 4096
      tokens (the SSD scan in every layer, flash attention at each site)
      and 16 ``decode_step`` s; at 6 layers (one site) against the plain
      path and ``forward``.

    Each engine and each model's params are freed before the next.
    Returns each model's record."""
    from repro_torch.config import EngineConfig

    out = {}
    for arch, n_img, layers in FAMILY_PAGED:
        cfg = arch_config(arch, layers)
        prompts = prompts_for(cfg, 16, 33, 300, SEED + 70)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, params = build_engine(torch, dev, cfg, 4, 8)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        name = f"families_{arch}"
        rec, tokens = serve(torch, name, eng, prompts, 32)
        check_graphs(name, eng)
        if min(rec["launches"][k] for k in PAGED_KERNELS) == 0:
            raise AssertionError(f"{name}: launches {rec['launches']}")
        out[arch] = family_summary(eng, rec, init_s,
                                   **decode_bytes_share(eng, rec))
        del eng
        torch.cuda.empty_cache()
        graphs_against_eager(torch, dev, name, cfg, 4, 8, prompts, 32,
                             params=params, graph_rec=rec,
                             graph_tokens=tokens)
        if n_img:
            tokens = seeded_tokens(torch, dev, cfg, 2, VLM_TEXT_TOKENS,
                                   SEED + 74)
            img = image_embeds(torch, dev, cfg, 2, n_img, SEED + 75)
            # per prefill: one flash call a layer, seven GEMVs a layer
            seq = run_sequence(torch, dev, f"{name}_sequence", cfg, params,
                               tokens, 16, EngineConfig(weight_bits=4),
                               {"flash_attention": cfg.n_layers,
                                "bitplane_gemv": 7 * cfg.n_layers},
                               extra={"img_embeds": img})
            out[arch].update(sequence_summary(seq))
            del tokens, img
        emit(f"{name}_summary", **out[arch])
        del params
        torch.cuda.empty_cache()
        two = arch_config(arch, 2)
        whole_path_check(torch, dev, cfg=two,
                         prompts=prompts_for(two, 8, 33, 300, SEED + 71),
                         name=f"{name}_whole")
        if n_img:
            sequence_whole_check(torch, dev, f"{name}_sequence_whole", two,
                                 VLM_TEXT_TOKENS, 32, n_img=n_img)
        torch.cuda.empty_cache()

    cfg = arch_config(HYBRID, FAMILY_HYBRID_LAYERS)
    sites = cfg.n_layers // cfg.attn_every
    prompts = prompts_for(cfg, 8, 17, 64, SEED + 72)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng, params = build_engine(torch, dev, cfg, 4, 0, mode="slots",
                               max_new=16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    name = f"families_{HYBRID}"
    rec, _ = serve(torch, name, eng, prompts, 16)
    if eng.mode != "slots" or eng.cache["k"].shape[0] != sites:
        raise AssertionError(f"{name}: mode {eng.mode}, sites "
                             f"{eng.cache['k'].shape[0]}")
    out[HYBRID] = family_summary(eng, rec, init_s, sites=sites,
                                 attn_every=cfg.attn_every)
    del eng
    torch.cuda.empty_cache()
    tokens = seeded_tokens(torch, dev, cfg, 2, 4096, SEED + 76)
    # per prefill: one SSD scan a layer, flash attention at each site, the
    # ssm layers' in_proj / out_proj and the shared block's seven GEMVs at
    # each site
    seq = run_sequence(torch, dev, f"{name}_sequence", cfg, params, tokens,
                       16, EngineConfig(weight_bits=4),
                       {"ssd_scan": cfg.n_layers, "flash_attention": sites,
                        "bitplane_gemv": 2 * cfg.n_layers + 7 * sites})
    out[HYBRID].update(sequence_summary(seq))
    emit(f"{name}_summary", **out[HYBRID])
    del params, tokens
    torch.cuda.empty_cache()
    cut = arch_config(HYBRID, 2 * cfg.attn_every)
    graphs_against_eager(torch, dev, f"{name}_{cut.n_layers}", cut, 4, 0,
                         prompts_for(cut, 8, 17, 64, SEED + 73), 16,
                         mode="slots")
    torch.cuda.empty_cache()
    sequence_whole_check(torch, dev, f"{name}_sequence_whole",
                         arch_config(HYBRID, cfg.attn_every), 3840, 256)
    torch.cuda.empty_cache()
    # every kernel of the three paths, launched by route
    emit("families_launches", **{
        arch: dict(routes=rec_["routes"], launches=rec_["launches"],
                   **{k: rec_[k] for k in ("sequence_prefill_launches",
                                           "sequence_prefill_gemv_routes",
                                           "sequence_prefill_flash_routes",
                                           "sequence_decode_gemv_routes")
                      if k in rec_})
        for arch, rec_ in out.items()})
    return out


def kernel_label(name: str) -> str:
    """A profiler kernel name without its namespace, return type and
    arguments: ``dec::decode_mma_kernel<4, 16>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0]


# the decode step's kernels of this port, by the labels' prefixes
DECODE_KERNELS = {"bitplane_gemv": ("dec::decode_",),
                  "paged_decode_attention": ("paged_decode_",)}


def _trace_windows(events, labels):
    """The device operations of each ``record_function`` window named in
    ``labels``: per window its length, operations, the port's decode
    kernels among them, their summed and their merged (busy) device ms;
    and over all windows the device ms and count of each operation by
    name."""
    from torch.autograd import DeviceType

    windows = {e.name: (e.time_range.start, e.time_range.end)
               for e in events if e.device_type == DeviceType.CPU
               and e.name in labels}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("chip_smoke.step.")]
    kept, by_name, launches = [], {}, {}
    for label in labels:
        lo_w, hi_w = windows[label]
        inside = [e for e in device if lo_w <= e.time_range.start
                  and e.time_range.end <= hi_w]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in inside)
        busy, edge = 0.0, -math.inf
        for lo, hi in spans:
            if hi > edge:
                busy += hi - max(lo, edge)
                edge = hi
        for e in inside:
            name = kernel_label(e.name)
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
            launches[name] = launches.get(name, 0) + 1
        ours = sum(kernel_label(e.name).startswith(prefixes)
                   for e in inside for prefixes in DECODE_KERNELS.values())
        kept.append(dict(window_ms=(hi_w - lo_w) / 1e3, ops=len(inside),
                         ours=ours, busy_ms=busy / 1e3,
                         device_ms=sum(hi - lo for lo, hi in spans) / 1e3))
    return kept, by_name, launches


def _trace_summary(kept, by_name, launches, top):
    n = len(kept)
    per = {name: ms / n for name, ms in by_name.items()}
    return per, dict(
        device_kernel_ms_per_step=sum(k["device_ms"] for k in kept) / n,
        kernels_per_step=sum(k["ops"] for k in kept) / n,
        device_busy_share=sum(k["busy_ms"] for k in kept)
        / sum(k["window_ms"] for k in kept),
        by_kernel=[dict(name=name, ms_per_step=ms,
                        launches_per_step=launches[name] / n)
                   for name, ms in sorted(per.items(),
                                          key=lambda kv: -kv[1])[:top]])


def profile_decode_steps(torch, eng, prompts, n_steps=4, n_chunks=2,
                         name="main_profile"):
    """Device time of ``n_steps`` paged decode steps (and of ``n_chunks``
    prefill chunks), by kernel, and the device's busy share of a step.

    Submits ``prompts`` to the engine and drives ``ServeEngine.step``
    inside one ``torch.profiler`` session, each step in its own
    ``record_function`` window that ends with a synchronize; keeps the
    first ``n_steps`` steps that ran a decode step and no prefill chunk,
    and the first ``n_chunks`` that ran a chunk and no decode step (on an
    engine whose graphs are captured: replays).  Reports per kept step the
    device milliseconds of every kernel (and copy) by name, their sum, and
    the busy share: the union of their intervals over the step's window.
    The profiler slows a step down, so the engine then runs dry
    unprofiled, with CUDA events around each call of its decode step:
    ``replay_ms`` is the device time of the step's graph (its kernels and
    the gaps between them), ``replay_share`` that time over the step's
    host wall time (from its start to a synchronize after it).  If the
    profiler records none of the port's decode kernels in a decode step
    (as when it cannot see inside a graph's replay), no kernel breakdown
    is given (``source``).
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    for p in prompts:
        eng.submit(p)

    def ran_parts(before):
        return tuple(len(eng.timings[part]) > before[part]
                     for part in ("prefill", "decode"))

    def counts():
        return {part: len(eng.timings[part]) for part in ("prefill",
                                                          "decode")}

    decode_labels, chunk_labels, n_profiled = [], [], 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        while eng.has_work() and len(decode_labels) < n_steps:
            before = counts()
            torch.cuda.synchronize()
            label = f"chip_smoke.step.{n_profiled}"
            n_profiled += 1
            with record_function(label):
                eng.step()
                torch.cuda.synchronize()
            ran = ran_parts(before)
            if ran == (False, True):
                decode_labels.append(label)
            elif ran == (True, False) and len(chunk_labels) < n_chunks:
                chunk_labels.append(label)
    events = prof.events()
    kept, by_name, launches = _trace_windows(events, decode_labels)

    # unprofiled: CUDA events around each call of the decode step
    step_fn, replays = eng._decode_paged, []

    def timed_step():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn()
        end.record()
        replays.append((start, end))
        return out

    eng._decode_paged = timed_step
    plain = []
    try:
        while eng.has_work():
            before = counts()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            if ran_parts(before) == (False, True):
                plain.append((1e3 * (time.perf_counter() - t0),
                              replays[-1][0].elapsed_time(replays[-1][1])))
    finally:
        eng._decode_paged = step_fn
    n = len(kept)
    if n == 0 or not plain:
        raise AssertionError(f"{name}: no decode-only step ran")
    have_trace = all(k["ours"] > 0 for k in kept)
    rec = dict(steps=n, source="torch.profiler" if have_trace
               else "cuda_events", cuda_graphs=eng.cuda_graphs,
               profiled_window_ms=[k["window_ms"] for k in kept],
               profiled_device_ops_per_step=[k["ops"] for k in kept],
               unprofiled_steps=len(plain),
               step_wall_ms=sum(w for w, _ in plain) / len(plain),
               replay_ms=sum(r for _, r in plain) / len(plain),
               replay_share=sum(r for _, r in plain)
               / sum(w for w, _ in plain))
    if have_trace:
        per, summary = _trace_summary(kept, by_name, launches, 20)
        rec.update(summary, port_kernels_ms_per_step={
            kernel: sum(ms for name, ms in per.items()
                        if name.startswith(prefixes))
            for kernel, prefixes in DECODE_KERNELS.items()})
        if chunk_labels:
            chunks = _trace_windows(events, chunk_labels)
            rec["prefill_chunk"] = dict(
                chunks=len(chunk_labels),
                window_ms=[k["window_ms"] for k in chunks[0]],
                **_trace_summary(*chunks, 12)[1])
    emit(name, **rec)
    return rec


def whole_path_check(torch, dev, cfg=None, prompts=None, max_len=1024,
                     name="whole", kv_bits=8):
    """Kernel engine vs plain-backend engine at 2 layers, full width
    (``cfg``; qwen2.5-3b by default, on 8 prompts of 33-300 tokens).

    Greedy tokens must agree.  Both paths round activations to bf16, and a
    bf16 rounding of a sum added in another order may fall the other way,
    so where two candidate tokens are nearly tied the choice may
    legitimately differ: a request whose tokens differ passes only if, at
    its first difference, the plain path's top two logits lie within
    ``2 * logit_tol`` of each other (the comparison of that request stops
    there, as the two continuations differ).

    ``logit_tol``: the logits here stay below 8 in magnitude, where a bf16
    ulp is 2^-5; two layers of bf16 activations whose roundings may fall
    either way, then the bf16 rounding of each logit, stay within four
    such ulps.

    """
    import numpy as np

    logit_tol = 0.125
    if cfg is None:
        cfg = full_config(n_layers=2)
        prompts = prompts_for(cfg, 8, 33, 300, SEED + 6)
    records = {}
    params = None
    for run, kw in (("cuda", {}),
                    ("plain", dict(backend="reference",
                                   attn_backend="gather"))):
        eng, params = build_engine(torch, dev, cfg, 4, kv_bits, max_new=16,
                                   params=params, max_len=max_len, **kw)
        seen = {}
        sample = eng._sample_next

        def record(req, _sample=sample, _seen=seen):
            _seen.setdefault(req.rid, []).append(
                np.array(req.last_logits, dtype=np.float32))
            return _sample(req)

        eng._sample_next = record
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        del eng._sample_next   # the wrapper held the engine in a cycle
        records[run] = ([r.output for r in reqs], seen, eng)
    (tok_k, log_k, eng_k), (tok_p, log_p, eng_p) = (records["cuda"],
                                                    records["plain"])
    if (eng_k.plan.backend, eng_k.attn_backend) != ("cuda", "cuda") or (
            eng_p.plan.backend, eng_p.attn_backend) != ("reference",
                                                        "gather"):
        raise AssertionError(f"{name}: engines did not resolve as asked")
    first_err = max(float(np.abs(log_k[i][0] - log_p[i][0]).max())
                    for i in log_p)
    if first_err > logit_tol:
        raise AssertionError(f"{name}: first-step logits differ by "
                             f"{first_err} > {logit_tol}")
    identical, near_ties = 0, []
    for rid, (a, b) in enumerate(zip(tok_k, tok_p)):
        if a == b:
            identical += 1
            continue
        i = next(j for j in range(len(b)) if a[j] != b[j])
        # the audio family's (K, V) logits: codebook 0 is sampled
        top2 = np.sort(log_p[rid][i].reshape(-1, eng_p.cfg.vocab_size)[0]
                       )[-2:]
        margin = float(top2[1] - top2[0])
        if margin > 2 * logit_tol:
            raise AssertionError(
                f"{name}: request {rid} differs at token {i} where the plain "
                f"path's margin is {margin}")
        near_ties.append(dict(request=rid, token=i, margin=margin))
    emit(name, model=cfg.name, layers=cfg.n_layers,
         windows=sorted({0 if cfg.is_global_layer(i) else cfg.sliding_window
                         for i in range(cfg.n_layers)}),
         requests=len(prompts), prompt_tokens=[len(p) for p in prompts],
         identical_requests=identical, near_tie_divergences=near_ties,
         first_step_logit_max_abs_err=first_err,
         first_step_logit_max_abs=max(float(np.abs(v[0]).max())
                                      for v in log_p.values()),
         logit_tol=logit_tol, dtype=cfg.dtype, kv_bits=kv_bits)


# ---------------------------------------------- full-sequence kernels
def flash_inputs(torch, dev, gen, dt, s=None, **shape):
    sh = {**FLASH_SHAPE, **shape}
    s = s or sh["s"]
    q = torch.randn((sh["b"], s, sh["hq"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    k = torch.randn((sh["b"], s, sh["hkv"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    v = torch.randn((sh["b"], s, sh["hkv"], sh["d"]), generator=gen,
                    device=dev).to(dt)
    return q, k, v


def flash_plain(q, k, v, window):
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               window=window).transpose(1, 2)


def flash_tol(torch, dt):
    # float32: sum order and 64-key online-softmax steps against one
    # softmax per row; bfloat16 output: one rounding of float32 values
    # that may differ in their last bits, one bf16 ulp (2^-7 of the value)
    return (1e-5, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-5)


# flash_parity's cases beside FLASH_SHAPE: (dtype name, S, window, shape
# changes); bfloat16 takes the tensor-core route, float32 the CUDA-core one
FLASH_CASES = [("bfloat16", 4096, 0, {}), ("bfloat16", 4100, 0, {}),
               ("bfloat16", 4096, 1024, {}),
               # a (1, 2) rank of mesh_prefill: 8 of 16 query heads, 1 of
               # 2 KV heads
               ("bfloat16", 4096, 0, dict(hq=8, hkv=1)),
               ("bfloat16", 2048, 0, dict(hq=8, hkv=8, d=64)),
               ("bfloat16", 1000, 0, dict(hq=16, hkv=2, d=32)),
               ("bfloat16", 777, 1, dict(hq=4, hkv=4, d=128)),
               ("float32", 4096, 0, {}),
               # head dims the tiles take zero-padded: zamba2-7b's 112 and
               # the reduced configs' 16
               ("bfloat16", 4096, 0, dict(d=112)),
               ("bfloat16", 1000, 64, dict(hq=8, hkv=2, d=16)),
               ("float32", 2048, 0, dict(d=112)),
               ("float32", 1000, 0, dict(hq=8, hkv=2, d=16)),
               # head dims past 128: the tiles' 256, and 192 padded to it
               ("bfloat16", 2048, 0, dict(d=256)),
               ("bfloat16", 1000, 64, dict(hq=8, hkv=2, d=192)),
               ("float32", 1000, 0, dict(d=256)),
               ("float32", 777, 37, dict(hq=8, hkv=2, d=192)),
               # zamba2-7b's shared block: D 112 padded, G 1 (32 heads)
               ("bfloat16", 2048, 0, dict(hq=32, hkv=32, d=112)),
               ("float32", 1000, 0, dict(hq=32, hkv=32, d=112)),
               # head dims past the tiles: both dtypes on the wide route's
               # streamed design
               ("bfloat16", 1000, 0, dict(hq=8, hkv=2, d=320)),
               ("bfloat16", 777, 100, dict(hq=8, hkv=2, d=512)),
               ("float32", 1000, 100, dict(hq=8, hkv=2, d=320)),
               ("float32", 777, 0, dict(hq=8, hkv=2, d=512))]


def flash_parity(torch, dev):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import flash_attention

    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, worst_used, cases = 0.0, 0.0, []
    for dname, s, window, shape in FLASH_CASES:
        dt = getattr(torch, dname)
        q, k, v = flash_inputs(torch, dev, gen, dt, s, **shape)
        before = route_counts("flash_attention")
        y = flash_attention(q, k, v, window=window)
        took = [r for r, n in route_counts("flash_attention").items()
                if n > before[r]]
        r = flash_plain(q, k, v, window)
        rtol, atol = flash_tol(torch, dt)
        err, used = check_close("flash_attention", y, r, rtol, atol, s=s,
                                window=window, dtype=dname, **shape)
        worst, worst_used = max(worst, err), max(worst_used, used)
        d = shape.get("d", FLASH_SHAPE["d"])
        want = ("wide" if d > 256 else
                "cuda_core" if dt == torch.float32 else "tensor_core")
        if took != [want] or route(dt, d) != want:
            raise AssertionError(f"flash_attention {dname} D {d}: routes "
                                 f"{took}")
        cases.append(dict(s=s, window=window, dtype=dname, route=want,
                          **{**{k_: FLASH_SHAPE[k_] for k_ in
                                ("hq", "hkv", "d")}, **shape},
                          max_abs_err=err, max_share_of_tol=used))
        del q, k, v, y, r
    torch.cuda.synchronize()
    emit("parity", kernel="flash_attention", cases=cases, batch=2,
         tolerance="float32: rtol=atol=1e-5; bfloat16: rtol 2^-7 (one "
                   "ulp), atol 1e-5", max_abs_err=worst,
         max_share_of_tol=worst_used, routes=route_counts("flash_attention"))


def flash_time(torch, dev, **shape):
    """Kernel / plain / library times of one prefill attention call:
    two 4096-token prompts, bf16, window 0 (``shape``: changes to
    ``FLASH_SHAPE``)."""
    import torch.nn.functional as F

    from repro_torch.roofline import kernel_costs
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
        route as flash_route,
    )

    sh = {**FLASH_SHAPE, **shape}
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = flash_inputs(torch, dev, gen, dt, **shape)
    y = flash_attention_cuda(q, k, v)
    rtol, atol = flash_tol(torch, dt)
    err, _ = check_close("flash_attention", y, flash_plain(q, k, v, 0),
                         rtol, atol)
    n_bytes, n_ops = kernel_costs.flash_attention(
        sh["b"], sh["s"], sh["hq"], sh["hkv"], sh["d"], q.element_size())
    bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
    sets = [tuple(t.clone() for t in (q, k, v))
            for _ in range(n_copies(n_bytes))]
    ms = timed_ms(lambda a, b, c: flash_attention_cuda(a, b, c), sets, torch)
    plain_ms = timed_ms(lambda a, b, c: flash_plain(a, b, c, 0), sets[:3],
                        torch)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in ts)
                for ts in sets]
    del sets
    lib = timed_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), lib_sets, torch)
    del lib_sets
    rec = dict(kernel="flash_attention", **sh, window=0, dtype="bfloat16",
               route=flash_route(dt, sh["d"]),
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               plain_ms=plain_ms, library_ms=lib,
               library="F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, D) copies",
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


def ssd_inputs(torch, dev, gen, b=None, s=None, h=None, n=None,
               dtype="bfloat16"):
    """Seeded SSD-scan inputs at the ssm shape (``SSD_SHAPE``) unless given:
    xdt, B and C in ``dtype``, la float32 <= 0."""
    sh = SSD_SHAPE
    b, s, h, n = (b or sh["b"], s or sh["s"], h or sh["h"],
                  n or sh["n"])
    dt = getattr(torch, dtype)
    xdt = (0.1 * torch.randn((b, s, h, sh["p"]), generator=gen,
                             device=dev)).to(dt)
    la = -0.2 * torch.rand((b, s, h), generator=gen, device=dev)
    b_in = torch.randn((b, s, n), generator=gen, device=dev).to(dt)
    c_in = torch.randn((b, s, n), generator=gen, device=dev).to(dt)
    return xdt, la, b_in, c_in


def ssd_tol(r):
    # chunked float32 sums and exponentials of float32 cumulative decays
    # against the float64 recurrence: 1e-4 of the largest output
    return 1e-4, 1e-4 * float(r.abs().max())


def ssd_parity(torch, dev):
    """``SSD_CASES`` through ``ops.ssd_scan`` against the float64
    recurrence, each call twice (the same bits)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import kernel_chunk
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    worst, worst_used, cases = 0.0, 0.0, []
    for b, s, h, n, chunk, dtype in SSD_CASES:
        inputs = ssd_inputs(torch, dev, gen, b, s, h, n, dtype)
        ry, rh = ssd_scan_ref(*inputs)
        before = _build.LAUNCHES["ssd_scan"]
        y, hf = ssd_scan(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        if _build.LAUNCHES["ssd_scan"] != before + 1:
            raise AssertionError("ssd_scan: the wrapper did not launch")
        again = ssd_scan(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, again[0]) and torch.equal(hf, again[1])):
            raise AssertionError(f"ssd_scan: two calls differ in their bits "
                                 f"(B={b}, S={s}, H={h}, N={n}, "
                                 f"chunk={chunk}, {dtype})")
        kc = kernel_chunk(chunk, s)
        case = dict(b=b, s=s, h=h, n=n, chunk=chunk, kernel_chunk=kc,
                    chunks=-(-s // kc), last_chunk=s - (-(-s // kc) - 1) * kc,
                    dtype=dtype)
        for name, out, ref in (("y", y, ry), ("h", hf, rh)):
            rtol, atol = ssd_tol(ref)
            err, used = check_close("ssd_scan", out, ref, rtol, atol,
                                    output=name, **case)
            worst, worst_used = max(worst, err), max(worst_used, used)
            case[f"max_abs_err_{name}"] = err
            case[f"share_of_tol_{name}"] = used
        cases.append(case)
    emit("parity", kernel="ssd_scan", cases=cases,
         tolerance="rtol 1e-4, atol 1e-4*max|ref| against the float64 "
                   "recurrence; every call twice, the same bits",
         max_abs_err=worst, max_share_of_tol=worst_used)


def ssd_time(torch, dev):
    """Kernel / plain times of one prefill SSD call (mamba2-130m heads,
    four 4096-token prompts, chunk 256), and its three kernels' device
    times.  No single PyTorch call computes the scan: library_ms is
    null."""
    from repro_torch.roofline import kernel_costs
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    sh, chunk = SSD_SHAPE, 256
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    inputs = ssd_inputs(torch, dev, gen)
    y, _ = ssd_scan_cuda(*inputs, chunk=chunk)
    ry, _ = ssd_scan_ref(*inputs)
    rtol, atol = ssd_tol(ry)
    err, _ = check_close("ssd_scan", y, ry, rtol, atol)
    xdt, la, b_in, _ = inputs
    b, s, nh, p, n = sh["b"], sh["s"], sh["h"], sh["p"], sh["n"]
    nc = s // chunk
    n_bytes, n_ops = kernel_costs.ssd_scan(
        b, s, nh, p, n, chunk, xdt.element_size(), la.element_size(),
        b_in.element_size())
    bms, by = bound_ms(n_bytes, n_ops, "bfloat16")
    sets = [tuple(t.clone() for t in inputs)
            for _ in range(n_copies(n_bytes))]
    ms = timed_ms(lambda *a: ssd_scan_cuda(*a, chunk=chunk), sets, torch)
    plain_ms = timed_ms(lambda *a: ssd_scan_ref(*a), sets[:2], torch)
    # the three kernels of one call, device microseconds (torch.profiler)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for args in sets[:5]:
            ssd_scan_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    kernel_us = {e.key.split("<")[0].split("::")[-1]:
                 e.device_time_total / e.count
                 for e in prof.key_averages() if e.device_time_total > 0}
    del sets
    rec = dict(kernel="ssd_scan", **sh, chunk=chunk, dtype="bfloat16",
               max_abs_err=err, tol=dict(rtol=rtol, atol=atol), ms=ms,
               earlier_ms=EARLIER_MS["ssd_scan"], kernel_us=kernel_us,
               plain_ms=plain_ms, library_ms=None,
               blocks=dict(chunk_states=nh * nc * b,
                           state_scan=p * n // 1024 * nh * b,
                           outputs=2 * nh * nc * b),
               bytes=n_bytes, ops=n_ops, bound_ms=bms, bound_by=by)
    emit("time", **rec)
    return rec


# ------------------------------------------------ full-sequence phases
def seeded_tokens(torch, dev, cfg, b, s, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(
        dev, torch.int32)


def image_embeds(torch, dev, cfg, b, n, seed):
    """Seeded stand-ins for a vision tower's patch embeddings ``(b, n,
    D)``, at the token embeddings' scale (std 0.02)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, n, cfg.d_model), generator=gen, device=dev)
            * 0.02).to(getattr(torch, cfg.dtype))


def run_sequence(torch, dev, name, cfg, params, tokens, n_decode, ecfg,
                 expect, extra=None):
    """``init_cache`` + one-shot ``prefill`` + greedy ``decode_step`` s,
    the decode steps as replays of one CUDA graph (``serve.StepGraph``;
    the step time leaves its capture out); checks finite logits and the
    kernel launches, returns the record.  ``extra``: more of the prefill
    batch (a vlm's ``img_embeds``, whose positions the cache holds too)."""
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import StepGraph

    extra = extra or {}
    # ``expect`` counts the layers' kernels of one prefill; an untied
    # ``lm_head`` is one more GEMV in the prefill (at M = B: the logits of
    # the last position only) and in each decode step
    head = 0 if cfg.tie_embeddings else 1
    layer_gemvs = expect["bitplane_gemv"]
    expect = {**expect, "bitplane_gemv": layer_gemvs + head}
    b, s = tokens.shape
    n_img = extra["img_embeds"].shape[1] if "img_embeds" in extra else 0
    cache = init_cache(cfg, b, n_img + s + n_decode + 32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens, **extra}, cfg, cache,
                            ecfg)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf_launches = dict(_build.LAUNCHES)
    pf_routes = route_counts("bitplane_gemv")
    pf_flash_routes = route_counts("flash_attention")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite prefill logits")
    _build.reset_launches()
    out = []
    # the graph's token buffer, refilled on the device after every step
    nxt = torch.argmax(logits[:, -1].float(), -1)[:, None].int()
    step = StepGraph(lambda: decode_step(params, cache, nxt, cfg, ecfg)[0])
    # each step's device span between CUDA events (the first two: the
    # eager call and the capture), for the median step
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(n_decode + 1)]
    t0 = time.perf_counter()
    for i in range(n_decode):
        marks[i].record()
        out.append(nxt.clone())
        logits = step()
        nxt.copy_(torch.argmax(logits[:, -1].float(), -1)[:, None])
    marks[-1].record()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0 - step.capture_seconds
    step_ms = sorted(marks[i].elapsed_time(marks[i + 1])
                     for i in range(n_decode))
    dec_launches = dict(_build.LAUNCHES)
    dec_routes = route_counts("bitplane_gemv")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: non-finite decode logits")
    toks = torch.cat(out, 1)
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{name}: token outside the vocabulary")
    rec = dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
               batch=b, prompt_tokens=s, image_positions=n_img,
               weight_bits=ecfg.weight_bits, prefill_s=t_prefill,
               prefill_tok_s=b * (n_img + s) / t_prefill,
               decode_steps=n_decode, decode_step_ms=1e3 * t_decode / n_decode,
               decode_tok_s=b * n_decode / t_decode,
               decode_capture_s=step.capture_seconds,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               prefill_launches=pf_launches, decode_launches=dec_launches,
               prefill_gemv_routes=pf_routes, decode_gemv_routes=dec_routes,
               prefill_flash_routes=pf_flash_routes,
               decode_step_ms_p50=step_ms[n_decode // 2])
    emit(name, **rec)
    for kernel, want in expect.items():
        if pf_launches[kernel] != want:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{pf_launches[kernel]} times in prefill, "
                                 f"expected {want}")
    if pf_routes["tensor_core"] != layer_gemvs or pf_routes["decode"] != head:
        raise AssertionError(f"{name}: prefill GEMV routes {pf_routes}")
    # bf16 activations: every flash launch on the tensor-core route
    if pf_flash_routes != {"cuda_core": 0, "tensor_core":
                           expect.get("flash_attention", 0), "wide": 0}:
        raise AssertionError(f"{name}: prefill flash attention routes "
                             f"{pf_flash_routes}")
    # each decode step runs the prefill's GEMVs once, all at M = B
    want_decode = n_decode * expect["bitplane_gemv"]
    if dec_launches["bitplane_gemv"] != want_decode or (
            dec_routes["decode"] != want_decode):
        raise AssertionError(f"{name}: decode GEMV routes {dec_routes}, "
                             f"expected {want_decode} on decode")
    return rec


def long_path(torch, dev):
    from repro_torch.config import EngineConfig
    from repro_torch.models import init_params

    cfg = full_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, engine_bits=4)
    tokens = seeded_tokens(torch, dev, cfg, 2, 4096, SEED + 7)
    # per prefill: one flash call per layer, seven GEMVs per layer
    return run_sequence(torch, dev, "long", cfg, params, tokens, 32,
                        EngineConfig(weight_bits=4),
                        {"flash_attention": cfg.n_layers,
                         "bitplane_gemv": 7 * cfg.n_layers})


def ssm_config(**changes):
    from repro_torch.config import get_arch

    return dataclasses.replace(get_arch("mamba2-130m"), **changes)


def ssm_path(torch, dev):
    from repro_torch.config import EngineConfig
    from repro_torch.models import init_params

    cfg = ssm_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, engine_bits=4)
    tokens = seeded_tokens(torch, dev, cfg, 4, 4096, SEED + 8)
    # per prefill: one SSD scan per layer, in_proj and out_proj per layer
    return run_sequence(torch, dev, "ssm", cfg, params, tokens, 32,
                        EngineConfig(weight_bits=4),
                        {"ssd_scan": cfg.n_layers,
                         "bitplane_gemv": 2 * cfg.n_layers})


def slots_path(torch, dev):
    """Slots-mode serving: full-width mamba2-130m (the ssm family's only
    serving mode) at ``weight_bits=4``, 8 slots, max_len 1024, 16 prompts
    of 33-300 tokens entering by sequential decode, 32 new tokens each,
    every step a replayed graph of the full-sequence ``decode_step``.  Then
    graph against eager at 2 layers, and qwen2.5-3b (``kv_bits=0``) cut to
    4 layers: the dense family's frozen-slot K/V rows on the card."""
    cfg = ssm_config()
    eng, _ = build_engine(torch, dev, cfg, 4, 0, mode="slots")
    rec, _ = serve(torch, "slots", eng, prompts_for(cfg, 16, 33, 300, SEED),
                   32)
    del eng
    torch.cuda.empty_cache()
    cut = ssm_config(n_layers=2)
    graphs_against_eager(torch, dev, "slots_ssm", cut, 4, 0,
                         prompts_for(cut, 8, 33, 100, SEED + 30), 32,
                         mode="slots")
    dense = full_config(n_layers=4)
    graphs_against_eager(torch, dev, "slots_dense", dense, 4, 0,
                         prompts_for(dense, 4, 17, 48, SEED + 31), 16,
                         mode="slots")
    torch.cuda.empty_cache()
    return rec


def greedy_run(torch, cfg, params, tokens, n_decode, ecfg, graphs=False,
               extra=None):
    """Prefill + greedy decode, the decode steps eager or (``graphs``) as
    replays of one CUDA graph; returns (tokens (B, n), logits per step as
    float32 (B, V) each).  ``extra``: more of the prefill batch (a vlm's
    ``img_embeds``)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serve import StepGraph

    extra = extra or {}
    b, s = tokens.shape
    n_img = extra["img_embeds"].shape[1] if "img_embeds" in extra else 0
    cache = init_cache(cfg, b, n_img + s + n_decode, device=tokens.device)
    logits, cache = prefill(params, {"tokens": tokens, **extra}, cfg, cache,
                            ecfg)
    nxt = torch.empty((b, 1), dtype=torch.int32, device=tokens.device)

    def fn():
        return decode_step(params, cache, nxt, cfg, ecfg)[0]

    step = StepGraph(fn) if graphs else fn
    steps, out = [logits[:, -1].to(torch.float32, copy=True)], []
    for _ in range(n_decode):
        nxt.copy_(torch.argmax(steps[-1], -1)[:, None])
        out.append(nxt.clone())
        # a copy: the next replay overwrites the graph's logits
        steps.append(step()[:, -1].to(torch.float32, copy=True))
    torch.cuda.synchronize()
    return torch.cat(out, 1), steps


def check_tokens(name, tok_a, tok_b, steps_b, logit_tol):
    """Greedy streams agree, up to a near tie: where they first differ,
    the second path's top two logits lie within ``2 * logit_tol``."""
    identical, near_ties = 0, []
    for lane in range(tok_a.shape[0]):
        a, b = tok_a[lane].tolist(), tok_b[lane].tolist()
        if a == b:
            identical += 1
            continue
        i = next(j for j in range(len(b)) if a[j] != b[j])
        top2 = steps_b[i][lane].topk(2).values
        margin = float(top2[0] - top2[1])
        if margin > 2 * logit_tol:
            raise AssertionError(f"{name}: lane {lane} differs at token {i} "
                                 f"where the margin is {margin}")
        near_ties.append(dict(lane=lane, token=i, margin=margin))
    return identical, near_ties


def long_whole_check(torch, dev):
    """At 2 layers, full width, for qwen2.5-3b (two 4096-token prompts) and
    mamba2-130m (two 3840-token prompts, so prompt and continuation fill
    whole 256-step chunks): :func:`sequence_whole_check`."""
    for cfg, s, n_decode in ((full_config(n_layers=2), 4096, 32),
                             (ssm_config(n_layers=2), 3840, 256)):
        sequence_whole_check(torch, dev, "long_whole", cfg, s, n_decode)
        torch.cuda.empty_cache()


def sequence_whole_check(torch, dev, name, cfg, s, n_decode, n_img=0):
    """The full-sequence path of ``cfg`` (cut in depth by the caller) on two
    seeded ``s``-token prompts (after ``n_img`` seeded image positions for
    a vlm):

    * kernel path (cuda GEMV, flash attention / SSD scan) against the plain
      path (``reference`` GEMV, ``gather``: plain ``attend_flash`` /
      ``ssd_chunked``): first-step logits within ``logit_tol``, greedy
      tokens equal up to near ties (as the ``whole`` phase holds them);
    * teacher forcing on the kernel path: ``forward`` over prompt and the
      generated tokens against the logits of ``prefill`` and each
      ``decode_step``, within ``logit_tol``.

    ``logit_tol``: the logits stay below 8 in magnitude, where a bf16 ulp is
    2^-5; two layers of bf16 activations whose roundings may fall either way
    (sums in other orders: flash vs cached decode attention, the GEMV's
    decode and prefill tilings, the SSD chunks vs the recurrence), then the
    bf16 rounding of each logit, stay within four such ulps.
    """
    from repro_torch.config import EngineConfig
    from repro_torch.models import forward, init_params

    logit_tol = 0.125
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, engine_bits=4)
    tokens = seeded_tokens(torch, dev, cfg, 2, s, SEED + 9)
    extra = ({"img_embeds": image_embeds(torch, dev, cfg, 2, n_img,
                                         SEED + 10)} if n_img else {})
    kern = EngineConfig(weight_bits=4)
    plain = EngineConfig(weight_bits=4, backend="reference",
                         attn_backend="gather")
    tok_k, steps_k = greedy_run(torch, cfg, params, tokens, n_decode, kern,
                                graphs=True, extra=extra)
    # the kernel path once more with every decode step eager: the graph
    # replays the same kernels, so the tokens are identical
    tok_e, steps_e = greedy_run(torch, cfg, params, tokens, n_decode, kern,
                                extra=extra)
    if not torch.equal(tok_k, tok_e):
        raise AssertionError(f"{name} {cfg.name}: graph and eager greedy "
                             "tokens differ")
    graph_err = max(float((a - b).abs().max())
                    for a, b in zip(steps_k, steps_e))
    tok_p, steps_p = greedy_run(torch, cfg, params, tokens, n_decode, plain,
                                extra=extra)
    first_err = float((steps_k[0] - steps_p[0]).abs().max())
    if first_err > logit_tol:
        raise AssertionError(f"{name} {cfg.name}: first-step logits differ "
                             f"by {first_err} > {logit_tol}")
    identical, near_ties = check_tokens(f"{name} {cfg.name}", tok_k, tok_p,
                                        steps_p, logit_tol)
    full_tokens = torch.cat([tokens, tok_k], 1)
    with torch.no_grad():   # scoring: the kernels refuse to run under autograd
        logits, _ = forward(params, {"tokens": full_tokens, **extra}, cfg,
                            kern)
    tf = logits[:, s - 1:].float()
    steps = torch.stack(steps_k, 1)
    tf_err = float((tf - steps).abs().max())
    if not bool(torch.isfinite(logits).all()) or tf_err > logit_tol:
        raise AssertionError(f"{name} {cfg.name}: forward vs prefill + "
                             f"decode logits differ by {tf_err} > "
                             f"{logit_tol}")
    emit(name, model=cfg.name, layers=cfg.n_layers, prompt_tokens=s,
         image_positions=n_img, decode_steps=n_decode,
         identical_lanes=identical, near_tie_divergences=near_ties,
         graph_vs_eager_tokens_identical=True,
         graph_vs_eager_logit_max_abs_diff=graph_err,
         first_step_logit_max_abs_err=first_err,
         teacher_forcing_logit_max_abs_err=tf_err, logit_tol=logit_tol)


# ---------------------------------------------------------------- train
TRAIN_TOKENS = ROOT / "build" / "train_tokens.bin"
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
# full width: AdamW, lr 3e-5 after one warmup step, cosine over 5 steps,
# two microbatches of one 1024-token sequence, every layer rematerialized
# (at 1e-3 and 1e-4 the full-width loss swung up to 13.30 and 14.42 by
# step 2 or 3: PERF.md, PR 24)
TRAIN_KW = dict(lr=3e-5, warmup_steps=1, total_steps=5, microbatches=2,
                remat="block")
TRAIN_STEPS = 5
TRAIN_SHAPE = (2, 1024)            # DataPipeline batch x seq
# the 2-layer cut at full width, float32: one step on the card against
# the CPU, and the restart drill
CUT_SHAPE = (2, 128)
CUT_RTOL = {"loss": 1e-4, "grad_norm": 1e-3}
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 4, 2, 3
DRILL_TOL = 1e-5


def zipf_tokens(cfg, n=1 << 20, seed=SEED, path=TRAIN_TOKENS):
    """A seeded int32 token file for ``DataPipeline(source="memmap")``:
    ids with natural text's Zipfian frequencies (exponent 1.1, ranks
    assigned to the vocabulary in a seeded order), a stream a model learns
    from within a few steps; the synthetic source's uniform ids leave a
    randomly initialised model nothing to learn but ``ln V``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ranks = np.minimum(rng.zipf(1.1, n) - 1, cfg.vocab_size - 1)
    ids = rng.permutation(cfg.vocab_size).astype(np.int32)[ranks]
    path.parent.mkdir(parents=True, exist_ok=True)
    ids.tofile(path)
    return str(path)


def train_pipeline(cfg, shape, path=TRAIN_TOKENS):
    """``shape`` batches of the Zipf file, written at ``path`` (each
    process that trains at once writes its own)."""
    from repro_torch.data import DataPipeline

    return DataPipeline(cfg, batch=shape[0], seq_len=shape[1], seed=SEED,
                        source="memmap", path=zipf_tokens(cfg, path=path))


def train_path(torch, dev):
    """Training at full width: qwen2.5-3b (36 layers, bf16, tied 151,936
    vocabulary), ``make_train_step`` with AdamW, ``remat="block"``, two
    microbatches and the loss through ``chunked_ce``, 5 steps of 2 x 1024
    tokens: each step's loss, grad norm, lr and ms, peak memory; the loss
    finite and lower at the last step than at the first.  Then
    :func:`train_cut_checks` at 2 layers."""
    from repro_torch.config import TrainConfig
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import stack_layers

    cfg = full_config()
    tcfg = TrainConfig(**TRAIN_KW)
    params = stack_layers(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED)))
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    pipe = train_pipeline(cfg, TRAIN_SHAPE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, _, m = step(params, opt, {}, pipe.batch_at(i))
        torch.cuda.synchronize()
        rec = dict(step=i, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   ms=1e3 * (time.perf_counter() - t0))
        steps.append(rec)
        emit("train_step", model=cfg.name, card=CARD, **rec)
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: losses {losses} are not finite and "
                             "falling")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = train_profile(torch, lambda: step(params, opt, {},
                                                pipe.batch_at(TRAIN_STEPS)))
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    # steady steps only: the first one allocates the state's buffers
    ms = sorted(r["ms"] for r in steps[1:])
    emit("train", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=cfg.dtype, params=n_params,
         optimizer=tcfg.optimizer, remat=tcfg.remat,
         microbatches=tcfg.microbatches, batch=TRAIN_SHAPE[0],
         seq=TRAIN_SHAPE[1], steps=TRAIN_STEPS, losses=losses,
         step_ms_p50=ms[len(ms) // 2], first_step_ms=steps[0]["ms"],
         tokens_per_s=tokens / (ms[len(ms) // 2] / 1e3), peak_mem_gib=peak,
         kernel_launches=sum(_build.LAUNCHES.values()), card=CARD)
    emit("train_profile", model=cfg.name, **profile, card=CARD)
    del params, opt, step
    torch.cuda.empty_cache()
    train_cut_checks(torch, dev)


def train_profile(torch, run_step, top=12):
    """One more train step under ``torch.profiler``: the device ms of its
    kernels and their number, the top ``top`` PyTorch operators by the
    device time of the kernels they launched, and the step's host ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = prof.key_averages()
    # a kernel's time appears twice: as its own entry and as the self
    # device time of the operator that launched it
    kernels = [e for e in events if "CUDA" in str(e.device_type)]
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_us, reverse=True)
    return dict(host_ms=host_ms,
                device_ms=sum(dev_us(e) for e in kernels) / 1e3,
                kernels=sum(e.count for e in kernels),
                top_ops=[dict(op=e.key, device_ms=dev_us(e) / 1e3,
                              calls=e.count) for e in ops[:top]])


def _trees_to(torch, tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev, copy=True), tree)


def train_cut_checks(torch, dev):
    """At qwen2.5-3b's full width cut to 2 layers, in float32, from seeded
    weights drawn on the CPU and one seeded batch (2 x 128 tokens, two
    microbatches): one ``make_train_step`` on the card against the same
    step on the CPU (loss within rtol 1e-4, grad norm within rtol 1e-3);
    then the restart drill: a ``Trainer`` checkpointing every 2 steps with
    a node failure injected at step 3 ends with the losses of an
    uninterrupted run, within 1e-5."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.config import TrainConfig
    from repro_torch.ft import FailureInjector
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.weights import stack_layers

    cfg = full_config(n_layers=2, dtype="float32")
    tcfg = TrainConfig(**TRAIN_KW)
    host = stack_layers(init_params(cfg, torch.Generator().manual_seed(SEED)))
    batch = train_pipeline(cfg, CUT_SHAPE).batch_at(0)
    got = {}
    for where in ("cuda", "cpu"):
        params = _trees_to(torch, host, dev if where == "cuda" else "cpu")
        t0 = time.perf_counter()
        _, _, _, m = make_train_step(cfg, tcfg)(params, adamw_init(params),
                                                {}, batch)
        got[where] = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
        got[where]["s"] = time.perf_counter() - t0
        del params
    rel = {k: abs(got["cuda"][k] - got["cpu"][k]) / abs(got["cpu"][k])
           for k in CUT_RTOL}
    emit("train_vs_cpu", model=cfg.name, layers=cfg.n_layers,
         dtype=cfg.dtype, batch=CUT_SHAPE[0], seq=CUT_SHAPE[1],
         on_card=got["cuda"], on_cpu=got["cpu"], rel_err=rel,
         rtol=CUT_RTOL, card=CARD)
    for k, tol in CUT_RTOL.items():
        if not rel[k] <= tol:
            raise AssertionError(f"train_vs_cpu: {k} on the card "
                                 f"{got['cuda'][k]} vs the CPU "
                                 f"{got['cpu'][k]}: {rel[k]} > {tol}")
    torch.cuda.empty_cache()

    def run(drill: bool):
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
        tr = Trainer(cfg, tcfg, _trees_to(torch, host, dev),
                     train_pipeline(cfg, CUT_SHAPE),
                     ckpt_manager=(CheckpointManager(str(TRAIN_CKPT), keep=2)
                                   if drill else None),
                     ckpt_every=DRILL_EVERY,
                     failure_injector=(FailureInjector(
                         schedule={DRILL_FAIL: 0}) if drill else None))
        t0 = time.perf_counter()
        hist = tr.run(DRILL_STEPS)["loss"]
        return tr, hist, time.perf_counter() - t0

    _, plain, plain_s = run(False)
    tr, drill, drill_s = run(True)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    # the drill's history: steps 0..f-1, then from its checkpoint's step
    # (the failure restores the last one) to the end, each against the
    # uninterrupted run's loss at the same step
    redo = DRILL_FAIL // DRILL_EVERY * DRILL_EVERY
    at_step = list(range(DRILL_FAIL)) + list(range(redo, DRILL_STEPS))
    err = max(abs(loss - plain[i]) for loss, i in zip(drill, at_step))
    emit("train_restart", model=cfg.name, layers=cfg.n_layers,
         steps=DRILL_STEPS, ckpt_every=DRILL_EVERY, failure_at=DRILL_FAIL,
         restarts=tr.restarts, uninterrupted=plain, drill=drill,
         max_abs_loss_diff=err, tol=DRILL_TOL, uninterrupted_s=plain_s,
         drill_s=drill_s, card=CARD)
    if tr.restarts != 1 or len(drill) != len(at_step) or err > DRILL_TOL:
        raise AssertionError(f"train_restart: {drill} after "
                             f"{tr.restarts} restarts against {plain}")
    del tr
    torch.cuda.empty_cache()


# ------------------------------------------------- slots-cache layouts
# qwen2.5-3b cut to 9 of 36 layers and zamba2-7b to 13 of 81 (2 of 13
# shared-attention sites), with the other depth cuts of PERF.md §4, to
# keep the whole run inside its time with phase ``launch``
LAYOUT_LANES, LAYOUT_STEPS, LAYOUT_LAYERS = 8, 64, 9
LAYOUT_KV8_TOL = 1e-3
SPLIT_LAYERS, SPLIT_LANES, SPLIT_STEPS, SPLIT_TOL = 6, 2, 1100, 2e-3
HYBRID_LANES, HYBRID_STEPS, HYBRID_LAYERS = 2, 32, 13


def layout_greedy(torch, dev, cfg, params, ecfg, first, n_steps, **layout):
    """Greedy ``decode_step`` s, eager, from an empty slots cache of the
    given layout, the first token ``first`` ``(B, 1)``: (tokens ``(B,
    n_steps)``, float32 logits of each step)."""
    from repro_torch.models import decode_step, init_cache

    cache = init_cache(cfg, first.shape[0], n_steps, device=dev, **layout)
    nxt, toks, steps = first, [], []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cache, nxt, cfg, ecfg)
        steps.append(logits[:, -1].float())
        nxt = torch.argmax(steps[-1], -1)[:, None].int()
        toks.append(nxt)
    torch.cuda.synchronize()
    return torch.cat(toks, 1), steps


def layouts_path(torch, dev):
    """The three decode-only slots-cache layouts on the card, eager and
    greedy from empty caches at ``weight_bits=4`` (the GEMV kernels run):

    * qwen2.5-3b (9 of 36 layers, 8 lanes, 64 steps): unstacked gives the
      stacked cache's tokens exactly, at full precision and int8; the
      int8 layouts give each other's logits within 1e-3 and the
      full-precision tokens up to near ties (``check_tokens``, the 0.125
      logit tolerance of the card's other bf16 comparisons);
    * gemma3-27b at full width cut to 6 layers (5 local, 1 global), in
      float32, 2 lanes, 1,100 steps (past the 1,024 window): the
      ``split_local`` cache, fed the uniform cache's greedy tokens, gives
      its logits within 2e-3 at every step;
    * zamba2-7b (13 of 81 layers, 2 shared-attention sites, 2 lanes, 32
      steps): unstacked gives the stacked cache's tokens exactly.
    """
    import numpy as np

    from repro_torch.config import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_cache, init_params

    ecfg = EngineConfig(weight_bits=4)
    rng = np.random.default_rng(SEED + 40)

    def first_tokens(cfg, b):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))).to(
            dev, torch.int32)

    def init(cfg):
        return init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           engine_bits=4)

    out = {}
    _build.reset_launches()
    cfg = full_config(n_layers=LAYOUT_LAYERS)
    params = init(cfg)
    first = first_tokens(cfg, LAYOUT_LANES)
    t0 = time.perf_counter()
    runs = {name: layout_greedy(torch, dev, cfg, params, ecfg, first,
                                LAYOUT_STEPS, **kw)
            for name, kw in (("stacked", {}), ("unstacked",
                                              dict(stacked=False)),
                             ("kv8", dict(kv_bits=8)),
                             ("kv8_unstacked", dict(kv_bits=8,
                                                    stacked=False)))}
    qwen_s = time.perf_counter() - t0
    for a, b in (("stacked", "unstacked"), ("kv8", "kv8_unstacked")):
        if not torch.equal(runs[a][0], runs[b][0]):
            raise AssertionError(f"layouts {cfg.name}: {b} tokens differ "
                                 f"from {a}'s")
    kv8_err = max(float((x - y).abs().max()) for x, y in
                  zip(runs["kv8"][1], runs["kv8_unstacked"][1]))
    if kv8_err > LAYOUT_KV8_TOL:
        raise AssertionError(f"layouts {cfg.name}: int8 stacked and "
                             f"unstacked logits differ by {kv8_err}")
    identical, ties = check_tokens(f"layouts {cfg.name} int8",
                                   runs["stacked"][0], runs["kv8"][0],
                                   runs["kv8"][1], 0.125)
    out[cfg.name] = dict(layers=cfg.n_layers, lanes=LAYOUT_LANES,
                         steps=LAYOUT_STEPS, seconds=qwen_s,
                         kv8_stacked_vs_unstacked_max_abs=kv8_err,
                         kv8_vs_full_identical_lanes=identical,
                         kv8_vs_full_near_ties=ties)
    del params, runs
    torch.cuda.empty_cache()

    # gemma3: the uniform cache greedy, the split cache fed its tokens
    cfg = arch_config("gemma3-27b", SPLIT_LAYERS, dtype="float32")
    params = init(cfg)
    b = SPLIT_LANES
    caches = {"uniform": init_cache(cfg, b, SPLIT_STEPS, device=dev),
              "split": init_cache(cfg, b, SPLIT_STEPS, split_local=True,
                                  device=dev)}
    if caches["split"]["k_local"].shape[2] != cfg.sliding_window:
        raise AssertionError("layouts: the split cache's ring is not "
                             "window-sized")
    nxt, err, t0 = first_tokens(cfg, b), 0.0, time.perf_counter()
    for _ in range(SPLIT_STEPS):
        lu, _ = decode_step(params, caches["uniform"], nxt, cfg, ecfg)
        ls, _ = decode_step(params, caches["split"], nxt, cfg, ecfg)
        err = max(err, float((lu - ls).abs().max()))
        nxt = torch.argmax(lu[:, -1], -1)[:, None].int()
    gemma_s = time.perf_counter() - t0
    if not err <= SPLIT_TOL:
        raise AssertionError(f"layouts {cfg.name}: split_local logits "
                             f"differ from the uniform cache's by {err}")
    out[cfg.name] = dict(layers=cfg.n_layers, dtype=cfg.dtype, lanes=b,
                         steps=SPLIT_STEPS, window=cfg.sliding_window,
                         split_vs_uniform_max_abs=err, tol=SPLIT_TOL,
                         seconds=gemma_s)
    del params, caches
    torch.cuda.empty_cache()

    cfg = arch_config(HYBRID, HYBRID_LAYERS)
    params = init(cfg)
    first = first_tokens(cfg, HYBRID_LANES)
    t0 = time.perf_counter()
    tok_s, _ = layout_greedy(torch, dev, cfg, params, ecfg, first,
                             HYBRID_STEPS)
    tok_u, _ = layout_greedy(torch, dev, cfg, params, ecfg, first,
                             HYBRID_STEPS, stacked=False)
    if not torch.equal(tok_s, tok_u):
        raise AssertionError(f"layouts {cfg.name}: unstacked tokens differ "
                             "from stacked")
    out[cfg.name] = dict(layers=cfg.n_layers, lanes=HYBRID_LANES,
                         steps=HYBRID_STEPS,
                         seconds=time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    if not launches["bitplane_gemv"]:
        raise AssertionError("layouts: no bit-plane GEMV launched")
    emit("layouts", **out, launches=launches,
         gemv_routes=route_counts("bitplane_gemv"), card=CARD)


# ----------------------------------------------------------------- main
# ----------------------------------------------------------- mesh phase
MESH_SHAPES = ((1, 2), (2, 1))     # (data, model)
MESH_REQUESTS = 8                  # main's first 8 prompts
MESH_NEW = 16
MESH_TIMEOUT = 900                 # seconds for a mesh's ranks, build of
#                                    params and serving included
# one device's routing of each ``replay`` cell, saved for the ranks
MESH_ROUTES = ROOT / "build" / "mesh" / "routes"
# how a rank process is started: this script with ``--mesh-rank``
MESH_RANK_CMD = [sys.executable, str(Path(__file__).resolve())]


class MeshCell(NamedTuple):
    """A family cell of phase ``mesh``: a config at published width
    (``layers``: its depth cut, None for all), served paged (``main``'s
    first prompts, ``kv_bits=8``; ``kv_bits=0`` in float32) or in slots
    mode (``MESH_SLOT_REQUESTS`` short prompts, ``kv_bits=0``), on each
    mesh of ``shapes``, in ``dtype``.  ``replay``: the ranks route as the
    single-device run did (:func:`replay_routes`)."""

    name: str
    arch: str
    layers: Optional[int]
    mode: str
    shapes: Tuple[Tuple[int, int], ...]
    dtype: str = "bfloat16"
    replay: bool = False


# PR 27 cut llava-next to 16 of 32 layers and the slots qwen2.5-3b cell
# to 12 of 36, to keep the whole run inside its time with the phase's
# new cells; then llava, musicgen, llama4, qwen3-moe and the slots
# qwen2.5-3b and zamba2 cells were halved for phase ``launch`` (PERF.md §4)
MESH_CELLS = [
    MeshCell("paged_llava", "llava-next-mistral-7b", 8, "paged",
             ((1, 2),)),
    MeshCell("paged_musicgen", "musicgen-medium", 24, "paged", ((1, 2),)),
    # in bf16 a rank's activations differ from one device's in the last
    # bits (the row-parallel partials add in another order, and a K split
    # depends on a linear's local N), enough to flip a router choice at a
    # near tie and send a token to another expert, after which the two
    # runs part; so the ranks replay one device's routing, and at every
    # choice of their own that differs, the router logits must be at a
    # near tie (``replay_routes``)
    MeshCell("paged_llama4", "llama4-scout-17b-a16e", 6, "paged",
             ((1, 2),), replay=True),
    MeshCell("paged_qwen3_moe", "qwen3-moe-235b-a22b", 4, "paged",
             ((1, 2),), replay=True),
    # the two MoE configs at 2 layers in float32, with float32 pages: the
    # routing agrees with one device's, and these hold the ranks' own
    # routing, tokens and touched experts to one device's
    MeshCell("paged_llama4_f32", "llama4-scout-17b-a16e", 2, "paged",
             ((1, 2),), "float32"),
    MeshCell("paged_qwen3_moe_f32", "qwen3-moe-235b-a22b", 2, "paged",
             ((1, 2),), "float32"),
    MeshCell("slots_qwen2.5", "qwen2.5-3b", 6, "slots", ((1, 2), (2, 1))),
    MeshCell("slots_mamba2", "mamba2-130m", None, "slots", ((1, 2), (2, 1))),
    MeshCell("slots_zamba2", "zamba2-7b", 6, "slots", ((1, 2),)),
    # two local layers: the window's ring past 1024 tokens on a rank (the
    # global layers are dense attention, as qwen2.5-3b's cell has it)
    MeshCell("slots_gemma3", "gemma3-27b", 2, "slots", ((1, 2),)),
]
MESH_SLOT_REQUESTS = 4             # prompts of 8-16 tokens in slots mode
MESH_SLOT_NEW = 8
MESH_SLOT_MAX_LEN = 64
# gemma3's cell adds one prompt past its 1024-token window (5 local
# layers, 1 global): one token a step in slots mode
MESH_GEMMA3_LONG = 1040
def mesh_shapes():
    """The kernels' shapes on the mesh ranks of this phase, read from the
    port's serving placement (``rank_shapes``), so that they follow the
    cells: ``gemv``, the ``(K, N)`` of a ``(1, 2)`` rank of full-width
    qwen2.5-3b (``main``'s mesh; its tied head is a plain product);
    ``family_gemv``, those of every family cell's rank on each of its
    meshes that ``gemv`` lacks (an untied head included: llava-next,
    musicgen, llama4-scout, qwen3-moe and zamba2 cut theirs over the
    model axis); ``grouped``, ``(K, N, E_local, top_k)`` of a rank's
    stacked experts; ``heads``, the ``(Hkv, G, Dh)`` of the paged cells'
    ranks (slots mode runs the plain attention), ``main``'s first."""
    from repro_torch.dist.sharding import rank_shapes

    main = rank_shapes(full_config(), (1, 2))
    family, grouped, heads = {}, {}, {main.heads: None}
    for cell in MESH_CELLS:
        cfg = arch_config(cell.arch, cell.layers)
        for shape in cell.shapes:
            got = rank_shapes(cfg, shape)
            family.update(dict.fromkeys(s for s in got.linears
                                        if s not in main.linears))
            grouped.update(dict.fromkeys(e + (cfg.top_k,)
                                         for e in got.experts))
            if cell.mode == "paged" and got.heads:
                heads[got.heads] = None
    return dict(gemv=list(main.linears), family_gemv=list(family),
                grouped=list(grouped), heads=list(heads))


def mesh_parity(torch, dev):
    """The kernels at the shapes a rank of the mesh gives them
    (:func:`mesh_shapes`), against the plain versions: the bit-plane GEMV
    at ``main``'s rank linears (decode M 4 and 8, tensor_core M 128 and
    256, bf16, 4 and 8 bits) and at every family cell's (M 2, 4, 8 and
    256, 4 bits), the grouped launch at a rank's experts (decode and
    chunk bounds, routed counts), and both paged-attention kernels at a
    rank's KV heads."""
    from repro_torch.kernels import _build
    from repro_torch.kernels._gemv import grouped_route
    from repro_torch.kernels.bitplane_gemv.ops import (
        bitplane_gemv,
        bitplane_gemv_grouped,
    )
    from repro_torch.kernels.bitplane_gemv.ref import (
        bitplane_gemv_grouped_ref,
        bitplane_gemv_ref,
    )
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention,
        paged_prefill_attention,
    )
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_ref,
    )

    shapes = mesh_shapes()
    _build.reset_launches()
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    worst = {"gemv": [0.0, 0.0], "grouped": [0.0, 0.0], "decode": [0.0, 0.0],
             "prefill": [0.0, 0.0]}
    gemv_cases = [(bits, k, n, m) for bits in (4, 8)
                  for (k, n) in shapes["gemv"] for m in (4, 8, 128, 256)]
    gemv_cases += [(4, k, n, m) for (k, n) in shapes["family_gemv"]
                   for m in (2, 4, 8, 256)]
    for bits, k, n, m in gemv_cases:
        packed, scale, x = gemv_case(torch, dev, gen, bits, k, n, m,
                                     torch.bfloat16)
        y = bitplane_gemv(packed, scale, x, bits=bits,
                          out_dtype=torch.bfloat16)
        r = bitplane_gemv_ref(packed, scale, x, bits=bits,
                              out_dtype=torch.bfloat16)
        rtol, atol = gemv_tol(torch.bfloat16, r)
        res = check_close("bitplane_gemv", y, r, rtol, atol,
                          bits=bits, m=m, k=k, n=n, mesh=True)
        worst["gemv"] = [max(a, b) for a, b in zip(worst["gemv"],
                                                   res)]
    for k, n, experts, top_k in shapes["grouped"]:
        for mode, bound in GROUPED_BOUNDS.items():
            tokens = 1 if mode == "decode" else 32
            counts = routed_counts(torch, dev, gen, experts, top_k, 8,
                                   tokens, bound // 8)
            packed, scale, x, offsets, rows = grouped_case(
                torch, dev, gen, 4, k, n, counts, torch.bfloat16)
            y = bitplane_gemv_grouped(packed, scale, x, offsets,
                                      max_rows=bound, bits=4,
                                      out_dtype=torch.bfloat16)
            r = bitplane_gemv_grouped_ref(packed, scale, x, offsets,
                                          max_rows=bound, bits=4,
                                          out_dtype=torch.bfloat16)
            rtol, atol = gemv_tol(torch.bfloat16, r)
            res = check_close("bitplane_gemv_grouped", y[:rows], r[:rows],
                              rtol, atol, k=k, n=n, experts=experts,
                              route=grouped_route(bound, torch.bfloat16),
                              mesh=True)
            worst["grouped"] = [max(a, b_) for a, b_ in
                                zip(worst["grouped"], res)]
            del packed, scale, x, y, r
    b, page, nblk, c = 8, 16, 24, 32
    for (hkv, g, dh), kind in itertools.product(shapes["heads"],
                                                ("int8", "bfloat16")):
        kp, vp, ks, vs = attn_pools(torch, dev, gen, kind, b * nblk + 1,
                                    page, hkv, dh)
        bt = (1 + torch.randperm(b * nblk, generator=gen, device=dev)
              ).reshape(b, nblk).int()
        rtol, atol = attn_tol(kind)
        cur = torch.tensor([0, 15, 16, 33, 129, 250, 301, page * nblk - 1],
                           dtype=torch.int32, device=dev)
        q = torch.randn((b, 1, hkv * g, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        y = paged_attention(q, kp, vp, bt, cur, 0, ks, vs)
        r = paged_attention_ref(q, kp, vp, bt, cur, 0, ks, vs)
        res = check_close("paged_decode_attention", y, r, rtol, atol,
                          kind=kind, hkv=hkv, g=g, dh=dh, mesh=True)
        worst["decode"] = [max(a, b) for a, b in zip(worst["decode"], res)]
        pos0 = torch.tensor([0, 7, 16, 45, 100, 201, 300, 120],
                            dtype=torch.int32, device=dev)
        seq = pos0 + c
        seq[6] = pos0[6] + 5
        qp = torch.randn((b, c, hkv * g, dh), generator=gen,
                         device=dev).to(torch.bfloat16)
        y = paged_prefill_attention(qp, kp, vp, bt, pos0, seq, 0, ks, vs)
        r = paged_prefill_ref(qp, kp, vp, bt, pos0, seq, 0, ks, vs)
        res = check_close("paged_prefill_attention", y, r, rtol, atol,
                          kind=kind, hkv=hkv, g=g, dh=dh, mesh=True)
        worst["prefill"] = [max(a, b) for a, b in zip(worst["prefill"], res)]
    torch.cuda.synchronize()
    routes = {k: route_counts(k) for k in ("bitplane_gemv",
                                           "paged_prefill_attention")}
    if not (routes["bitplane_gemv"]["decode"]
            and routes["bitplane_gemv"]["tensor_core"]
            and routes["bitplane_gemv"]["grouped_decode"]
            and routes["bitplane_gemv"]["grouped_tensor_core"]
            and routes["paged_prefill_attention"]["tensor_core"]
            and _build.LAUNCHES["paged_decode_attention"]):
        raise AssertionError(f"mesh_parity: routes {routes}")
    emit("mesh_parity", gemv_shapes=shapes["gemv"], gemv_m=[4, 8, 128, 256],
         bits=[4, 8], family_gemv_shapes=shapes["family_gemv"],
         family_gemv_m=[2, 4, 8, 256], grouped_shapes=shapes["grouped"],
         grouped_bounds=GROUPED_BOUNDS,
         attention=f"(Hkv, G, Dh) {shapes['heads']}, page 16, int8 and "
                   "bf16 pools, decode and chunk 32",
         tolerance="bf16 GEMV: rtol 2^-7, atol 1e-5*max|ref|; attention: "
                   "rtol=atol=2^-7",
         max_abs_err={k: v[0] for k, v in worst.items()},
         max_share_of_tol={k: v[1] for k, v in worst.items()},
         routes=routes)


def mesh_psum_check(torch, eng, mesh, rank):
    """``psum_bits=8`` against the exact sum of a row-parallel GEMV on
    the card: this rank's slice of layer 0's w_down (K 5504 of 11008) at
    M 8 in float32, ``|compressed - exact| <= n * scale / 2`` with the
    shared scale of the ranks' partials."""
    from repro_torch.dist.collectives import all_reduce
    from repro_torch.engine import EnginePlan
    from repro_torch.engine.backends import get_backend

    lin = eng.params["layers"][0]["mlp"]["w_down"]
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 60 + rank)
    x = torch.randn((8, lin.in_features), generator=gen, device=dev)
    plans = {bits: EnginePlan(backend="sharded", bits=lin.bits, mesh=mesh,
                              inner_backend="cuda", psum_bits=bits)
             for bits in (0, 8)}
    exact, comp = (plans[b].apply(lin, x) for b in (0, 8))
    part = get_backend("cuda")(plans[0], lin, x, torch.float32)
    group, n = mesh.group("model"), mesh.count("model")
    absmax = float(all_reduce(part.abs().amax(), group, op="max"))
    bound = n * (absmax / 127.0) / 2.0
    err = float((comp - exact).abs().max())
    if not err <= bound * 1.0001:
        raise AssertionError(f"mesh psum_bits=8: error {err} > {bound}")
    return dict(k_local=lin.in_features, n=lin.out_features, ranks=n,
                max_abs_err=err, bound=bound)


def mesh_cell_setup(cell):
    """``(cfg, prompts, max_new, build_engine keywords)`` of a family
    cell: paged, ``main``'s first ``MESH_REQUESTS`` prompts at 8 lanes,
    max_len 1024, ``kv_bits=8``; slots, ``MESH_SLOT_REQUESTS`` prompts of
    8-16 tokens (gemma3's last one past its window) at as many lanes,
    ``kv_bits=0``."""
    cfg = arch_config(cell.arch, cell.layers, dtype=cell.dtype)
    if cell.mode == "paged":
        return (cfg, prompts_for(cfg, 16, 33, 300, SEED)[:MESH_REQUESTS],
                MESH_NEW, dict(kv_bits=8 if cell.dtype == "bfloat16" else 0,
                               n_slots=8, max_len=1024))
    prompts = prompts_for(cfg, MESH_SLOT_REQUESTS, 8, 16, SEED + 80)
    max_len = MESH_SLOT_MAX_LEN
    if cfg.sliding_window:
        prompts[-1] = prompts_for(cfg, 1, MESH_GEMMA3_LONG,
                                  MESH_GEMMA3_LONG, SEED + 81)[0]
        max_len = MESH_GEMMA3_LONG + MESH_SLOT_MAX_LEN
    return cfg, prompts, MESH_SLOT_NEW, dict(
        kv_bits=0, n_slots=MESH_SLOT_REQUESTS, max_len=max_len,
        mode="slots")


def record_routes(torch):
    """Record every routing of the MoE blocks from now on (``moe.route``'s
    gates, experts and kept mask, as device copies).  Returns ``stop()``,
    which puts the router back and returns the records in call order."""
    from repro_torch.models import moe

    tape, route = [], moe.route

    def recording(params, x, cfg):
        out = route(params, x, cfg)
        tape.append(tuple(t.clone() for t in out[:3]))
        return out

    moe.route = recording

    def stop():
        moe.route = route
        return tape
    return stop


def replay_routes(torch, eng, path):
    """Make ``eng``'s MoE blocks route as the single-device run saved at
    ``path`` did (its gates, experts and kept mask, call by call), while
    each call still routes on its own as the witness: at the tokens a
    step runs (a decode step's active lanes, a chunk's prompt tokens; a
    padded position routes on whatever its row holds), where its experts
    differ from the replayed ones, the largest gap between the two
    choices' float32 router logits is that call's margin.  The sampler
    notes the call at which a token first parts from the single-device
    run's; from there on the inputs differ by more than rounding.
    Returns ``finish(check=True)``, which puts the router back and (with
    ``check``) returns the route calls, and the reroutes and their
    largest margin before the first parted token and after it."""
    from repro_torch.models import moe
    from repro_torch.models.layers import dense

    saved = torch.load(path)
    tape = [tuple(t.to(eng.device) for t in call) for call in saved["routes"]]
    want = saved["tokens"]
    route, sample = moe.route, eng._sample_next
    calls, parted = [], []

    def replaying(params, x, cfg):
        own = route(params, x, cfg)
        i = len(calls)
        if i >= len(tape) or tape[i][1].shape != own[1].shape:
            raise AssertionError(
                f"route call {i} of experts {tuple(own[1].shape)}: one "
                f"device made {len(tape)} calls")
        gates, experts, keep = tape[i]
        logits = dense(params["router"], x).to(torch.float32)
        lanes = eng.lanes
        if x.shape[1] == 1:
            runs = lanes.active[:, None]
        else:
            runs = (torch.arange(x.shape[1], device=x.device)
                    < (lanes.seq_lens - lanes.pos0)[:, None])
        differ = (own[1] != experts).any(-1) & runs
        gap = (logits.gather(-1, own[1])
               - logits.gather(-1, experts)).abs().amax(-1)
        calls.append((differ.sum(), torch.where(differ, gap, 0.0).amax()))
        return gates, experts, keep, own[3]

    def watching(req):
        tok = sample(req)
        if not parted and tok != want[req.rid][len(req.output)]:
            parted.append(len(calls))
        return tok

    moe.route, eng._sample_next = replaying, watching

    def finish(check=True):
        moe.route = route
        if not check:
            return None
        if len(calls) != len(tape):
            raise AssertionError(f"{len(calls)} route calls; one device "
                                 f"made {len(tape)}")
        n = parted[0] if parted else len(calls)
        counts = [int(c) for c, _ in calls]
        margins = [float(m) for _, m in calls]
        return dict(route_calls=len(calls),
                    parted_at_call=parted[0] if parted else None,
                    reroutes=sum(counts[:n]),
                    max_margin=max(margins[:n], default=0.0),
                    reroutes_after_parting=sum(counts[n:]),
                    max_margin_after_parting=max(margins[n:], default=0.0))
    return finish


# why a ``replay`` cell runs eagerly on one device and on the ranks
MESH_REPLAY_EAGER = ("replay_routes and record_routes are Python hooks run "
                     "once a route call; a graph replay runs no Python")


def mesh_cell_engine(torch, dev, cell, *, mesh=None, params=None):
    """A family cell's engine at ``weight_bits=4``: on this rank's shards
    with ``mesh`` (the ``sharded`` backend; graphs in segments), else on
    one device; ``params`` drawn from the seed unless given.  A
    ``replay`` cell runs eagerly (``MESH_REPLAY_EAGER``).  Returns
    ``(eng, params, prompts, max_new)``."""
    cfg, prompts, max_new, kw = mesh_cell_setup(cell)
    eng, params = build_engine(torch, dev, cfg, 4, kw.pop("kv_bits"),
                               max_new=max_new, params=params,
                               cuda_graphs=not cell.replay, mesh=mesh,
                               sharded=mesh is not None, **kw)
    return eng, params, prompts, max_new


def mesh_cell_record(torch, eng, rec, tokens, init_s, top=None):
    """A family cell's record of one run (a rank's or the single
    device's): tokens, tok/s, step and chunk ms, host ms in collectives a
    step (slots mode: every prompt token is a step), peak memory,
    launches by route, the graphs (segments a step on a rank, capture
    seconds); for moe, the experts this run holds and touched."""
    steps = rec["decode_steps"] + (rec["prompt_tokens"]
                                   if eng.mode == "slots"
                                   else rec["prefill_chunks"])
    coll, wait = eng.timings["collectives"], eng.timings["collective_wait"]
    out = dict(
        tokens=tokens, init_s=init_s, steps=steps,
        **{k: rec[k] for k in (
            "requests", "prompt_tokens", "tok_s", "seconds", "decode_steps",
            "decode_step_ms", "prefill_chunks", "prefill_chunk_ms",
            "peak_mem_gib", "launches", "route_launches",
            "gemv_decode_launches", "gemv_tensor_core_launches",
            "gemv_grouped_decode_launches",
            "gemv_grouped_tensor_core_launches")},
        collective_ms_per_step=1e3 * sum(coll) / max(steps, 1),
        collective_wait_ms_per_step=1e3 * sum(wait) / max(steps, 1),
        collective_calls=len(coll), layout=eng.mesh_layout,
        lanes=eng.lanes.tokens.shape[0],
        **(mesh_graph_record(eng) if eng.mesh is not None
           else dict(cuda_graphs=eng.cuda_graphs,
                     capture_s=sum(eng.timings["capture"]))))
    if eng.cfg.family == "moe":
        w_gate = eng.params["layers"][0]["moe"]["w_gate"]
        out.update(experts_held=w_gate.packed.shape[0],
                   experts_touched=dict(eng.experts_touched))
    if top is not None:
        out["top"] = {f"{rid}:{i}": cand for (rid, i), cand in top.items()}
    return out


def mesh_cell_run(torch, mesh, cell, label, rank):
    """One rank's run of a family cell (its engine freed after).  The
    ranks build their engines one at a time: a rank draws the whole model
    before it cuts its shards, and the ranks share the card."""
    import torch.distributed as dist

    for turn in range(mesh.size):
        if turn == mesh.rank:
            t0 = time.perf_counter()
            eng, params, prompts, max_new = mesh_cell_engine(
                torch, mesh.device, cell, mesh=mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            init_s = time.perf_counter() - t0
        dist.barrier()
    top = _recording_top(eng)
    finish = (replay_routes(torch, eng, MESH_ROUTES / f"{cell.name}.pt")
              if cell.replay else None)
    try:
        rec, tokens = serve(torch, f"mesh_{label}_{cell.name}_rank{rank}",
                            eng, prompts, max_new)
    except BaseException:
        if finish:
            finish(check=False)
        raise
    replay = finish() if finish else None
    out = mesh_cell_record(torch, eng, rec, tokens, init_s, top)
    if replay:
        out["replay"] = replay
    # the recording wrapper and the engine refer to each other
    del eng, top
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_graph_record(eng):
    """A mesh engine's graphs: on or not, graph segments a step by kind
    (a collective cuts a step, so ``(1, 2)`` steps run k + 1 segments
    for k collectives and ``(2, 1)`` ones a single segment), captures
    and their seconds."""
    kinds = (("decode", "prefill") if eng.mode == "paged"
             else ("decode",))
    return dict(
        cuda_graphs=eng.cuda_graphs,
        segments=({k: g.segments for k, g in zip(kinds, eng._graphs)}
                  if eng.cuda_graphs else None),
        graphs_captured=len(eng.timings["capture"]),
        capture_s=sum(eng.timings["capture"]))


def mesh_main_record(eng, rec, tokens, top):
    """One run of ``main``'s mesh traffic on a rank: tokens, step and
    chunk ms, host ms in collectives and waiting a step, peak memory,
    launches by route, the graphs' segments and capture seconds."""
    coll, wait = eng.timings["collectives"], eng.timings["collective_wait"]
    return dict(
        tokens=tokens, tok_s=rec["tok_s"], seconds=rec["seconds"],
        decode_steps=rec["decode_steps"],
        decode_step_ms=rec["decode_step_ms"],
        decode_step_ms_p50=rec["decode_step_ms_p50"],
        prefill_chunks=rec["prefill_chunks"],
        prefill_chunk_ms=rec["prefill_chunk_ms"],
        prefill_chunk_ms_p50=rec["prefill_chunk_ms_p50"],
        collective_ms_per_step=1e3 * sum(coll) / max(len(coll), 1),
        collective_wait_ms_per_step=1e3 * sum(wait) / max(len(wait), 1),
        collective_share=sum(coll) / max(sum(eng.timings["decode"])
                                         + sum(eng.timings["prefill"]),
                                         1e-12),
        peak_mem_gib=rec["peak_mem_gib"], launches=rec["launches"],
        route_launches=rec["route_launches"],
        gemv_decode_launches=rec["gemv_decode_launches"],
        gemv_tensor_core_launches=rec["gemv_tensor_core_launches"],
        top={f"{rid}:{i}": cand for (rid, i), cand in top.items()},
        **mesh_graph_record(eng))


def mesh_rank_main(argv) -> int:
    """One rank of phase ``mesh``: ``chip_smoke.py --mesh-rank R
    --mesh-shape DxM --mesh-dir DIR`` (started by :func:`mesh_path`).
    Serves ``main``'s first prompts on its shards with graph segments,
    then the same traffic eagerly; then each family cell of
    ``MESH_CELLS`` on this mesh in turn, and writes its record to
    ``DIR/rank{R}.json``."""
    import torch

    args = dict(zip(argv[1::2], argv[2::2]))
    rank = int(args["--mesh-rank"])
    label = args["--mesh-shape"]
    shape = tuple(int(v) for v in label.split("x"))
    out = Path(args["--mesh-dir"])
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist import close_rank, init_rank, make_mesh, transport

    backend = init_rank(rank, math.prod(shape), str(out / "store"))
    mesh = make_mesh(shape, ("data", "model"))
    torch.cuda.set_device(mesh.device)
    cfg = full_config()
    prompts = prompts_for(cfg, 16, 33, 300, SEED)[:MESH_REQUESTS]
    t0 = time.perf_counter()
    eng, params = build_engine(torch, mesh.device, cfg, 4, 8,
                               max_new=MESH_NEW, mesh=mesh, sharded=True)
    del params
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    res = dict(
        rank=rank, coord=mesh.coord, device=str(mesh.device),
        backend=backend, transport=transport(mesh), init_s=init_s,
        layout=eng.mesh_layout, pool=list(eng.pages.k.shape),
        lanes=eng.lanes.tokens.shape[0], runs={})
    for run in ("graphs", "eager"):
        if run == "eager":
            # the same params, drawn again from the seed: a rank keeps
            # only its shards while it serves
            eng, params = build_engine(torch, mesh.device, cfg, 4, 8,
                                       max_new=MESH_NEW, cuda_graphs=False,
                                       mesh=mesh, sharded=True)
            del params
            torch.cuda.empty_cache()
        top = _recording_top(eng)
        rec, tokens = serve(
            torch, f"mesh_{label}_rank{rank}" + ("_eager" if run == "eager"
                                                 else ""),
            eng, prompts, MESH_NEW)
        res["runs"][run] = mesh_main_record(eng, rec, tokens, top)
        if run == "eager" and mesh.shape["model"] > 1:
            res["psum8"] = mesh_psum_check(torch, eng, mesh, rank)
        del eng, top
        gc.collect()
        torch.cuda.empty_cache()
    res["cells"] = {cell.name: mesh_cell_run(torch, mesh, cell, label, rank)
                    for cell in MESH_CELLS if shape in cell.shapes}
    res["slice"] = mesh_slice_rank(torch, mesh, label)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    close_rank()
    return 0


def run_mesh_ranks(shape):
    """Start one rank process per mesh position (rendezvous through a
    file store under ``build/mesh``), wait for all of them, and return
    their records; a rank that fails or outlives ``MESH_TIMEOUT`` fails
    the phase, and every process is stopped either way."""
    label = "x".join(map(str, shape))
    work = ROOT / "build" / "mesh" / label
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    logs = ROOT / "chiprun_out"
    logs.mkdir(exist_ok=True)
    procs = []
    try:
        for r in range(math.prod(shape)):
            log = open(logs / f"mesh_{label}_rank{r}.log", "w")
            procs.append((subprocess.Popen(
                MESH_RANK_CMD + [
                 "--mesh-rank", str(r), "--mesh-shape", label,
                 "--mesh-dir", str(work)], stdout=log,
                stderr=subprocess.STDOUT, cwd=ROOT), log))
        deadline = time.monotonic() + MESH_TIMEOUT
        for r, (p, log) in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc:
                log.flush()
                tail = (logs / f"mesh_{label}_rank{r}.log").read_text()
                raise AssertionError(f"mesh {label}: rank {r} exited {rc}:"
                                     f"\n{tail[-3000:]}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def mesh_references(torch, dev, params):
    """The single-device eager engine of every family cell, each freed
    before the next (qwen2.5-3b at full depth on ``main``'s params); their
    records.  A
    ``replay`` cell's routing and tokens go to ``MESH_ROUTES``, for its
    ranks to replay."""
    refs = {}
    for cell in MESH_CELLS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, cell_params, prompts, max_new = mesh_cell_engine(
            torch, dev, cell,
            params=(params if cell.arch == "qwen2.5-3b"
                    and cell.layers is None else None))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        stop = record_routes(torch) if cell.replay else None
        try:
            rec, tokens = serve(torch, f"mesh_single_{cell.name}", eng,
                                prompts, max_new)
        finally:
            tape = stop() if stop else None
        if tape is not None:
            MESH_ROUTES.mkdir(parents=True, exist_ok=True)
            torch.save({"routes": [tuple(t.cpu() for t in call)
                                   for call in tape], "tokens": tokens},
                       MESH_ROUTES / f"{cell.name}.pt")
        refs[cell.name] = mesh_cell_record(torch, eng, rec, tokens, init_s)
        del eng, cell_params
        torch.cuda.empty_cache()
    return refs


def mesh_family_checks(label, shape, ranks, refs):
    """The family cells of one mesh against their single-device runs:
    every rank's tokens the same and equal to one device's up to near
    ties; every rank launched the GEMV's decode route, a paged cell also
    its chunk route (tensor-core, rows in float32) and both attention
    kernels, a moe cell both grouped routes over its own ``E / model``
    experts, whose touched counts, summed over the ranks, equal one
    device's (every prefill chunk; every decode step too when no token
    parted at a near tie, or when the ranks replayed one device's
    routing).  A ``replay`` cell's ranks route as one device did, and
    every choice of their own that differs from it must be at a router
    near tie (logits within ``2 * CHAOS_LOGIT_TOL``) up to the first
    parted token.  Returns each cell's summary."""
    out = {}
    n_model = shape[1]
    for cell in MESH_CELLS:
        if shape not in cell.shapes:
            continue
        name = f"mesh_{label}_{cell.name}"
        recs = [r["cells"][cell.name] for r in ranks]
        ref = refs[cell.name]
        cfg = arch_config(cell.arch, cell.layers, dtype=cell.dtype)
        chunk = "tensor_core" if cell.dtype == "bfloat16" else "rows"
        routes = []
        for r, rec in enumerate(recs):
            if rec["tokens"] != recs[0]["tokens"]:
                raise AssertionError(f"{name}: rank {r}'s tokens differ "
                                     "from rank 0's")
            gemv = route_counts("bitplane_gemv", rec["route_launches"])
            ok = gemv["decode"] > 0
            if cell.mode == "paged":
                ok = ok and gemv[chunk] > 0 and all(
                    rec["launches"][k] for k in PAGED_KERNELS)
            if cfg.family == "moe":
                ok = ok and gemv["grouped_decode"] > 0 and (
                    gemv[f"grouped_{chunk}"] > 0) and (
                    rec["experts_held"] == cfg.n_experts // n_model)
            if not ok:
                raise AssertionError(f"{name}: rank {r} launches "
                                     f"{rec['launches']} {gemv}, experts "
                                     f"{rec.get('experts_held')}")
            # graphs on every cell but a replaying one; a step cut at its
            # collectives at (1, 2), whole at (2, 1)
            segs = set((rec["segments"] or {}).values())
            if rec["cuda_graphs"] == cell.replay or (
                    rec["cuda_graphs"] and not (
                        segs == {1} if n_model == 1
                        else min(segs) > 1)):
                raise AssertionError(f"{name}: rank {r} graphs "
                                     f"{rec['cuda_graphs']}, segments "
                                     f"{rec['segments']}")
            if cell.replay and (rec["replay"]["max_margin"]
                                > 2 * CHAOS_LOGIT_TOL):
                raise AssertionError(f"{name}: rank {r} routes otherwise "
                                     "than one device past a near tie: "
                                     f"{rec['replay']}")
            routes.append(gemv)
        top = {}
        for key, cand in recs[0]["top"].items():
            rid, i = map(int, key.split(":"))
            top[rid, i] = {int(t): v for t, v in cand.items()}
        want = dict(enumerate(ref["tokens"]))
        got = dict(enumerate(recs[0]["tokens"]))
        ties = near_ties(name, want, got, top)
        touched = same_touched = None
        if cfg.family == "moe":
            touched = {kind: [sum(v) for v in zip(
                *(rec["experts_touched"][kind] for rec in recs))]
                for kind in ("decode", "prefill")}
            single = ref["experts_touched"]
            same_touched = {kind: sum(a == b for a, b in zip(
                touched[kind], single[kind])) for kind in touched}
            if touched["prefill"] != single["prefill"] or (
                    (cell.replay or not ties)
                    and touched["decode"] != single["decode"]):
                raise AssertionError(f"{name}: experts touched, summed over "
                                     f"the ranks, {touched}; one device "
                                     f"{single}")
        per_rank = [{k: rec[k] for k in (
            "init_s", "tok_s", "seconds", "steps", "decode_steps",
            "decode_step_ms", "prefill_chunks", "prefill_chunk_ms",
            "collective_ms_per_step", "collective_wait_ms_per_step",
            "collective_calls", "peak_mem_gib", "launches", "lanes",
            "layout", "cuda_graphs", "segments", "capture_s")}
            | {"gemv_routes": g}
            | {k: rec[k] for k in ("experts_held", "replay") if k in rec}
            for rec, g in zip(recs, routes)]
        out[cell.name] = dict(
            model=cfg.name, family=cfg.family, mode=cell.mode,
            layers=cfg.n_layers,
            layers_published=arch_config(cell.arch).n_layers,
            requests=recs[0]["requests"],
            prompt_tokens=recs[0]["prompt_tokens"], ranks=per_rank,
            exact=sum(recs[0]["tokens"][rid] == w
                      for rid, w in want.items()),
            dtype=cell.dtype, replayed_routing=cell.replay, near_ties=ties,
            **({"eager_because": MESH_REPLAY_EAGER} if cell.replay
               else {}),
            experts_touched_summed=touched,
            steps_touching_as_one_device=same_touched,
            single={k: ref[k] for k in (
                "init_s", "tok_s", "decode_step_ms", "prefill_chunk_ms",
                "peak_mem_gib", "cuda_graphs")})
    return out


# ------------------------------------------- the mesh cells of PR 27
# snapshot / restore and chaos on a mesh (paged, main's params), the
# one-shot prefill on a mesh (flash at a rank's heads, the SSD scan on a
# whole SSM block) and the tensor-parallel train step
MESH_WORK = ROOT / "build" / "mesh"
MESH_SNAPSHOTS = MESH_WORK / "snapshots"
MESH_SNAP_SLOTS = 4        # main's first 8 prompts queue behind 4 lanes
MESH_CHAOS = dict(seed=SEED, schedule={
    "page_grant": {4}, "step_fault": {3, 5, 11, 13}, "nan_logits": {6, 9},
    "preempt_storm": {8}})
MESH_CHAOS_RETRIES = 1
MESH_CHAOS_SHAPES = ((1, 2),)
# (name, arch, batch, seq, tokens' seed, meshes): long's and ssm's
# prefills, at full depth
MESH_PREFILL = [("qwen2.5", "qwen2.5-3b", 2, 4096, SEED + 7,
                 ((1, 2), (2, 1))),
                ("mamba2", "mamba2-130m", 4, 4096, SEED + 8, ((1, 2),))]
MESH_PREFILL_TOL = 0.125   # long_whole's bf16 logit bound
# qwen2.5-3b at full width, 4 of 36 layers, float32;
# one 1024-token
# sequence a data shard, AdamW (train's lr), remat, 3 steps over train's
# Zipf file, against one device on the same params and batches within
# the CPU tests' bounds (tests/test_torch_mesh_train.py PORT_TOL): loss
# and grad norm rel 1e-5, and the change of the rank's params over the
# steps, ||Δ_rank - Δ_one|| / ||Δ_one||, within 1e-3 (1.0 for a state
# left unchanged; an elementwise bound would not see that at this lr)
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_SEQ = 1024
MESH_TRAIN_STEPS = 3
MESH_TRAIN_KW = dict(lr=3e-5, warmup_steps=1, total_steps=5, remat="block")
MESH_TRAIN_TOL = dict(loss_rtol=1e-5, grad_norm_rtol=1e-5, change_rtol=1e-3)


def mesh_graph_addresses(torch, eng):
    """What a mesh engine's graphs replay by address: the pool, the lane
    buffers, each step's segments, the buffers of the collectives
    between them and the step's output."""
    return dict(
        pool={n: t.data_ptr() for n, t in eng._pool_tensors().items()},
        lanes={n: t.data_ptr() for n, t in vars(eng.lanes).items()},
        segments=[[id(seg) for seg in g.graph] for g in eng._graphs],
        host=[[a.data_ptr() for h in g.host_steps for a in h.args
               if isinstance(a, torch.Tensor)] for g in eng._graphs],
        outputs=[g.output.data_ptr() for g in eng._graphs])


def mesh_snapshot_rank(torch, mesh, label):
    """Cell ``mesh_snapshot`` on one rank: ``main``'s first 8 prompts on
    4 lanes (4-bit weights, int8 pages, graph segments), killed at the
    first restart point (``_restart_point``), snapshotted in memory and
    saved (``save_snapshot``: every rank gathers, the first writes), run
    on to the end.  Then the same engine, both step graphs captured,
    restores the in-memory snapshot in place (no new capture, every
    address its graphs replay unchanged) and runs to the end again; and a
    fresh rank engine loads the checkpoint, restores it and runs to the
    end.  Tokens: the uninterrupted run's, exactly or up to near ties."""
    import torch.distributed as dist

    from repro_torch.ckpt import checkpoint as ckpt

    cfg = full_config()
    prompts = prompts_for(cfg, 16, 33, 300, SEED)[:MESH_REQUESTS]
    kw = dict(n_slots=MESH_SNAP_SLOTS, max_new=MESH_NEW, mesh=mesh,
              sharded=True)
    eng, params = build_engine(torch, mesh.device, cfg, 4, 8, **kw)
    reqs, k = _drive(eng, prompts, len(prompts), until=_restart_point)
    in_flight = sum(not r.done for r in reqs)
    directory = MESH_SNAPSHOTS / label
    if mesh.rank == 0:
        shutil.rmtree(directory, ignore_errors=True)
    dist.barrier()
    snap = eng.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save_snapshot(str(directory), k)
    save_s = time.perf_counter() - t0
    while eng.has_work():
        eng.step()
    want = {r.rid: r.output for r in reqs}
    n_pages = eng.alloc.n_pages
    name = f"mesh_{label}_snapshot_rank{mesh.rank}"
    check_graphs(f"{name}_uninterrupted", eng)
    addresses = mesh_graph_addresses(torch, eng)
    captures = len(eng.timings["capture"])
    top = _recording_top(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore(snap)
    torch.cuda.synchronize()
    restore_in_place_s = time.perf_counter() - t0
    got = _finish(f"{name}_in_place", eng, in_flight, MESH_NEW)
    ties_in_place = near_ties(f"{name}_in_place",
                              {rid: want[rid] for rid in got}, got, top)
    exact_in_place = sum(got[r] == want[r] for r in got)
    new_captures = len(eng.timings["capture"]) - captures
    same_addresses = addresses == mesh_graph_addresses(torch, eng)
    segments = mesh_graph_record(eng)["segments"]
    if new_captures or not same_addresses:
        raise AssertionError(f"{name}: the in-place restore captured "
                             f"{new_captures} graphs, same addresses "
                             f"{same_addresses}")
    del eng, top, snap
    gc.collect()
    torch.cuda.empty_cache()
    fresh, _ = build_engine(torch, mesh.device, cfg, 4, 8, params=params,
                            **kw)
    top = _recording_top(fresh)
    t0 = time.perf_counter()
    extra = ckpt.read_manifest(str(directory), k)["extra"]
    template = {n: ckpt.template_leaf(s, d)
                for n, (s, d) in extra["array_specs"].items()}
    arrays, _ = ckpt.load_checkpoint(str(directory), template, k)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh.restore({"arrays": arrays, "host": extra["host"]})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = _finish(name, fresh, in_flight, MESH_NEW)
    ties = near_ties(name, {rid: want[rid] for rid in got}, got, top)
    rec = dict(k=k, in_flight=in_flight, save_s=save_s, load_s=load_s,
               restore_s=restore_s, n_pages=n_pages,
               layout=fresh.mesh_layout, pool=list(fresh.pages.k.shape),
               exact=sum(got[r] == want[r] for r in got), near_ties=ties,
               restore_in_place_s=restore_in_place_s,
               exact_in_place=exact_in_place,
               near_ties_in_place=ties_in_place,
               in_place_new_captures=new_captures,
               in_place_same_addresses=same_addresses, segments=segments,
               tokens=want)
    del fresh, params, top
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_chaos_run(torch, dev, mesh=None, params=None):
    """Cell ``mesh_chaos``'s traffic (``main``'s first 8 prompts on 4
    lanes, ``MESH_CHAOS``'s schedule, one retry a request) on this rank,
    or on one device without ``mesh``, on graphs: the injector's log,
    quarantines, retries, finish reasons and tokens."""
    from repro_torch.ft import ChaosInjector

    cfg = full_config()
    prompts = prompts_for(cfg, 16, 33, 300, SEED)[:MESH_REQUESTS]
    chaos = ChaosInjector(**MESH_CHAOS)
    eng, params = build_engine(
        torch, dev, cfg, 4, 8, n_slots=MESH_SNAP_SLOTS, max_new=MESH_NEW,
        params=params, chaos=chaos, mesh=mesh, sharded=mesh is not None,
        serve_kw=dict(max_request_retries=MESH_CHAOS_RETRIES))
    top = _recording_top(eng)
    reqs = [eng.submit(p) for p in prompts]
    t0 = time.perf_counter()
    eng.run()
    rec = dict(seconds=time.perf_counter() - t0,
               tokens={r.rid: r.output for r in reqs},
               reasons={r.rid: r.finish_reason for r in reqs},
               retries={r.rid: r.retries for r in reqs},
               quarantined=eng.quarantined, retried=eng.retried,
               log=[list(e) for e in chaos.log],
               top={f"{rid}:{i}": c for (rid, i), c in top.items()})
    del eng, top
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_prefill_cfg(arch):
    return full_config() if arch == "qwen2.5-3b" else ssm_config()


def mesh_prefill_rank(torch, mesh, label, name, arch, batch, seq, seed):
    """Cell ``mesh_prefill`` on one rank: the one-shot ``prefill(mesh=)``
    of ``batch x seq`` seeded tokens (the rank's rows) into the rank's
    slots cache, 4-bit weights on the ``sharded`` backend; its seconds,
    host ms in collectives, launches by route and peak memory.  The last
    positions' logits, gathered over the data shards, go to
    ``MESH_WORK`` for the parent to hold against one device's."""
    from repro_torch.config import EngineConfig
    from repro_torch.dist import collectives, local_shard, serve_param_specs
    from repro_torch.dist.collectives import all_gather
    from repro_torch.kernels import _build
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models.transformer import rank_view

    cfg, dev = mesh_prefill_cfg(arch), mesh.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         engine_bits=4)
    local = local_shard(params, serve_param_specs(mesh, params, cfg), mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    daxes = mesh.data_axes()
    rows = batch // mesh.count(daxes)
    lo = mesh.index(daxes) * rows
    tokens = seeded_tokens(torch, dev, cfg, batch, seq, seed)[lo:lo + rows]
    view = rank_view(local, cfg, mesh)
    cache = init_cache(cfg, rows, seq + 32, device=dev, n_kv_heads=view.hkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    collectives.reset_seconds()
    t0 = time.perf_counter()
    logits, _ = prefill(local, {"tokens": tokens}, cfg, cache,
                        EngineConfig(weight_bits=4, sharded=True), mesh=mesh)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    rec = dict(prefill_s=prefill_s, rows=rows, hq=view.hq, hkv=view.hkv,
               collective_ms=1e3 * collectives.SECONDS[0],
               collective_wait_ms=1e3 * collectives.WAIT[0],
               launches=dict(_build.LAUNCHES),
               flash_routes=route_counts("flash_attention"),
               gemv_routes=route_counts("bitplane_gemv"),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if mesh.count(daxes) > 1:
        logits = all_gather(logits, mesh.group(daxes), dim=0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"mesh_{label}_prefill_{name}: non-finite "
                             "logits")
    if mesh.rank == 0:
        torch.save(logits.float().cpu(),
                   MESH_WORK / f"prefill_{name}_{label}.pt")
    del local, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_train_cfg():
    return full_config(n_layers=MESH_TRAIN_LAYERS, dtype="float32")


def mesh_train_batches(cfg, n_data, tag):
    pipe = train_pipeline(cfg, (n_data, MESH_TRAIN_SEQ),
                          MESH_WORK / f"train_tokens_{tag}.bin")
    return [pipe.batch_at(i) for i in range(MESH_TRAIN_STEPS)]


def mesh_train_ref(torch, dev, label, n_data):
    """One device's steps of cell ``mesh_train`` on the global batch of
    ``n_data`` sequences: its metrics and step ms; the change of its
    params over the steps goes to ``MESH_WORK`` for the ranks to hold
    their shards' change against."""
    from repro_torch.config import TrainConfig
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    from repro_torch.weights import stack_layers

    cfg, tcfg = mesh_train_cfg(), TrainConfig(**MESH_TRAIN_KW)
    params = stack_layers(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED)))
    opt = adamw_init(params)
    step = make_train_step(cfg, tcfg)
    metrics = []
    for b in mesh_train_batches(cfg, n_data, "one_device"):
        t0 = time.perf_counter()
        params, opt, _, m = step(params, opt, {}, b)
        torch.cuda.synchronize()
        metrics.append(dict({k: float(v) for k, v in m.items()},
                            ms=1e3 * (time.perf_counter() - t0)))
    del opt, step
    start = stack_layers(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED)))
    torch.save(tree_map(lambda t, t0: (t - t0).cpu(), params, start),
               MESH_WORK / f"train_ref_{label}.pt")
    del params, start
    gc.collect()
    torch.cuda.empty_cache()
    return metrics


def mesh_train_rank(torch, mesh, label):
    """Cell ``mesh_train`` on one rank: ``make_train_step(mesh=)`` on its
    shards (``mesh_specs``: whole heads, MLP features and vocabulary over
    ``model``) and its data shard of each batch; each step's metrics, ms
    and host ms in collectives, peak memory, kernel launches (none: the
    loss runs the plain mixers), and how far the change of its shards
    over the steps is from the change of the same blocks of one device's
    params (``mesh_train_ref``; every rank's blocks together are the
    gathered tree): ``||Δ_rank - Δ_one|| / ||Δ_one||`` and the largest
    element of ``|Δ_rank - Δ_one|``."""
    from repro_torch.config import TrainConfig
    from repro_torch.dist import collectives, local_shard
    from repro_torch.kernels import _build
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.train.trainer import (make_train_step, mesh_specs,
                                           shard_train_state)
    from repro_torch.tree import tree_leaves
    from repro_torch.weights import stack_layers

    cfg, tcfg, dev = mesh_train_cfg(), TrainConfig(**MESH_TRAIN_KW), \
        mesh.device
    params = stack_layers(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED)))
    specs = mesh_specs(cfg, tcfg, mesh)
    state = shard_train_state(specs, mesh, params, adamw_init(params), {})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(cfg, tcfg, mesh=mesh)
    batches = mesh_train_batches(cfg, mesh.count(mesh.data_axes()),
                                 f"rank{mesh.rank}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    steps = []
    for b in batches:
        collectives.reset_seconds()
        t0 = time.perf_counter()
        p, o, e, m = step(*state, b)
        torch.cuda.synchronize()
        state = (p, o, e)
        steps.append(dict({k: float(v) for k, v in m.items()},
                          ms=1e3 * (time.perf_counter() - t0),
                          collective_ms=1e3 * collectives.SECONDS[0],
                          collective_wait_ms=1e3 * collectives.WAIT[0]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = sum(_build.LAUNCHES.values())
    params = state[0]
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    start = local_shard(stack_layers(init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED))),
        specs["params"], mesh)
    ref = local_shard(torch.load(MESH_WORK / f"train_ref_{label}.pt",
                                 mmap=True), specs["params"], mesh)
    err, num, den = 0.0, 0.0, 0.0
    for p, p0, d_one in zip(tree_leaves(params), tree_leaves(start),
                            tree_leaves(ref)):
        d_one = d_one.to(dev).double()
        diff = (p.double() - p0.double()) - d_one
        err = max(err, float(diff.abs().max()))
        num += float(torch.sum(torch.square(diff)))
        den += float(torch.sum(torch.square(d_one)))
    n_local = sum(t.numel() for t in tree_leaves(params))
    del params, start, ref
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=steps, peak_mem_gib=peak, kernel_launches=launches,
                change_rel_err=(num / den) ** 0.5,
                change_max_abs_err=err, params_local=n_local)


def mesh_slice_rank(torch, mesh, label):
    """This rank's cells of the slice on its mesh, each run in turn."""
    shape = (mesh.shape["data"], mesh.shape["model"])
    out = dict(snapshot=mesh_snapshot_rank(torch, mesh, label))
    if shape in MESH_CHAOS_SHAPES:
        out["chaos"] = mesh_chaos_run(torch, mesh.device, mesh)
    out["prefill"] = {
        name: mesh_prefill_rank(torch, mesh, label, name, arch, b, s, seed)
        for name, arch, b, s, seed, shapes in MESH_PREFILL
        if shape in shapes}
    out["train"] = mesh_train_rank(torch, mesh, label)
    return out


def mesh_slice_refs(torch, dev, params, shape, label):
    """The single-device references of the slice's cells on ``shape``,
    each freed before the next: the chaos run (on ``main``'s params), the
    prefills' last logits, the train steps (params to ``MESH_WORK``)."""
    from repro_torch.config import EngineConfig
    from repro_torch.models import init_cache, init_params, prefill

    MESH_WORK.mkdir(parents=True, exist_ok=True)
    refs = {"prefill": {}}
    if shape in MESH_CHAOS_SHAPES:
        refs["chaos"] = mesh_chaos_run(torch, dev, params=params)
    for name, arch, b, s, seed, shapes in MESH_PREFILL:
        if shape not in shapes:
            continue
        cfg = mesh_prefill_cfg(arch)
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        engine_bits=4)
        cache = init_cache(cfg, b, s + 32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = prefill(p, {"tokens": seeded_tokens(
            torch, dev, cfg, b, s, seed)}, cfg, cache,
            EngineConfig(weight_bits=4))
        torch.cuda.synchronize()
        refs["prefill"][name] = dict(logits=logits.float().cpu(),
                                     prefill_s=time.perf_counter() - t0)
        del p, cache, logits
        torch.cuda.empty_cache()
    refs["train"] = mesh_train_ref(torch, dev, label, shape[0])
    return refs


def mesh_slice_checks(torch, dev, params, label, shape, ranks, refs):
    """The slice's cells of one mesh against one device: every rank's
    records alike; the snapshot's tokens after a restore on the ranks
    (checked there) and, loaded into the single-device engine, equal to
    the mesh run's up to near ties; chaos: the same log, quarantines,
    retries and finish reasons as one device's, tokens up to near ties;
    the prefill's last logits within ``MESH_PREFILL_TOL`` of one
    device's, flash (tensor-core) and the SSD scan launched once a layer
    on every rank; the train step's losses, grad norms and change of the
    params within ``MESH_TRAIN_TOL`` of one device's and no kernel
    launched.  Emits
    ``mesh_snapshot`` / ``mesh_chaos`` / ``mesh_prefill`` /
    ``mesh_train`` and returns them."""
    recs = [r["slice"] for r in ranks]
    out = {}

    # snapshot: the mesh's snapshot into the single-device engine
    snap = [r["snapshot"] for r in recs]
    want = {int(rid): t for rid, t in snap[0]["tokens"].items()}
    for r, s in enumerate(snap):
        if {int(k): v for k, v in s["tokens"].items()} != want:
            raise AssertionError(f"mesh_{label}_snapshot: rank {r}'s "
                                 "tokens differ from rank 0's")
    cfg = full_config()
    eng, _ = build_engine(torch, dev, cfg, 4, 8, n_slots=MESH_SNAP_SLOTS,
                          max_new=MESH_NEW, params=params, cuda_graphs=False,
                          serve_kw=dict(n_pages=snap[0]["n_pages"]))
    top = _recording_top(eng)
    t0 = time.perf_counter()
    eng.load_snapshot(str(MESH_SNAPSHOTS / label))
    one_load_s = time.perf_counter() - t0
    eng.audit()
    name = f"mesh_{label}_snapshot_one_device"
    got = _finish(name, eng, snap[0]["in_flight"], MESH_NEW)
    one_ties = near_ties(name, {rid: want[rid] for rid in got}, got, top)
    del eng, top
    torch.cuda.empty_cache()
    out["snapshot"] = dict(
        model=cfg.name, lanes=MESH_SNAP_SLOTS, requests=MESH_REQUESTS,
        k=snap[0]["k"], in_flight=snap[0]["in_flight"],
        layout=snap[0]["layout"], pool=snap[0]["pool"],
        ranks=[{k: s[k] for k in (
            "save_s", "load_s", "restore_s", "exact", "near_ties",
            "restore_in_place_s", "exact_in_place", "near_ties_in_place",
            "in_place_new_captures", "in_place_same_addresses",
            "segments")} for s in snap],
        one_device=dict(load_s=one_load_s, near_ties=one_ties,
                        exact=sum(got[r] == want[r] for r in got)))
    emit("mesh_snapshot", mesh=label, **out["snapshot"], card=CARD)

    if "chaos" in refs:
        # the ranks' records came through JSON: so does the reference
        ref = json.loads(json.dumps(refs["chaos"]))
        runs = [r["chaos"] for r in recs]
        for r, run in enumerate(runs):
            for key in ("log", "quarantined", "retried", "reasons",
                        "retries"):
                if run[key] != ref[key]:
                    raise AssertionError(
                        f"mesh_{label}_chaos: rank {r}'s {key} "
                        f"{run[key]} differ from one device's {ref[key]}")
            if run["tokens"] != runs[0]["tokens"]:
                raise AssertionError(f"mesh_{label}_chaos: rank {r}'s "
                                     "tokens differ from rank 0's")
        sites = {site for site, _ in ref["log"]}
        if sites != {"page_grant", "step_fault", "nan_logits",
                     "preempt_storm"}:
            raise AssertionError(f"mesh_{label}_chaos: fired {sites}")
        top = {}
        for key, cand in runs[0]["top"].items():
            rid, i = map(int, key.split(":"))
            top[rid, i] = {int(t): v for t, v in cand.items()}
        ties = near_ties(f"mesh_{label}_chaos",
                         {int(k): v for k, v in ref["tokens"].items()},
                         {int(k): v for k, v in runs[0]["tokens"].items()},
                         top)
        out["chaos"] = dict(
            schedule={k: sorted(v) for k, v in
                      MESH_CHAOS["schedule"].items()},
            log=ref["log"], quarantined=ref["quarantined"],
            retried=ref["retried"], near_ties=ties,
            seconds=[run["seconds"] for run in runs],
            one_device_seconds=ref["seconds"])
        emit("mesh_chaos", mesh=label, **out["chaos"], card=CARD)

    out["prefill"] = {}
    for name, arch, b, s, seed, shapes in MESH_PREFILL:
        if shape not in shapes:
            continue
        pcfg = mesh_prefill_cfg(arch)
        got = torch.load(MESH_WORK / f"prefill_{name}_{label}.pt")
        err = float((got - refs["prefill"][name]["logits"]).abs().max())
        if err > MESH_PREFILL_TOL:
            raise AssertionError(f"mesh_{label}_prefill_{name}: last logits "
                                 f"{err} from one device's")
        kernel = "flash_attention" if arch == "qwen2.5-3b" else "ssd_scan"
        for r, run in enumerate(x["prefill"][name] for x in recs):
            ok = run["launches"][kernel] == pcfg.n_layers
            if kernel == "flash_attention":
                ok = ok and run["flash_routes"]["tensor_core"] == \
                    pcfg.n_layers
            if not ok or run["gemv_routes"]["tensor_core"] == 0:
                raise AssertionError(f"mesh_{label}_prefill_{name}: rank {r} "
                                     f"launches {run['launches']}, flash "
                                     f"{run['flash_routes']}")
        out["prefill"][name] = dict(
            model=pcfg.name, layers=pcfg.n_layers, batch=b, seq=s,
            logit_max_abs_err=err, logit_tol=MESH_PREFILL_TOL,
            one_device_prefill_s=refs["prefill"][name]["prefill_s"],
            ranks=[x["prefill"][name] for x in recs])
        emit("mesh_prefill", mesh=label, cell=name, **out["prefill"][name],
             card=CARD)

    ref = refs["train"]
    runs = [r["train"] for r in recs]
    for r, run in enumerate(runs):
        for st, rs in zip(run["steps"], ref):
            for key in ("loss", "grad_norm"):
                if abs(st[key] - rs[key]) > MESH_TRAIN_TOL[
                        f"{key}_rtol"] * abs(rs[key]):
                    raise AssertionError(
                        f"mesh_{label}_train: rank {r} {key} {st[key]}, "
                        f"one device {rs[key]}")
        if run["change_rel_err"] > MESH_TRAIN_TOL["change_rtol"] or (
                run["kernel_launches"]):
            raise AssertionError(
                f"mesh_{label}_train: rank {r}'s change of the params "
                f"{run['change_rel_err']} (relative) from one device's, "
                f"{run['kernel_launches']} kernel launches")
    tcfg = mesh_train_cfg()
    ms = sorted(st["ms"] for st in runs[0]["steps"][1:])
    out["train"] = dict(
        model=tcfg.name, layers=tcfg.n_layers, dtype=tcfg.dtype,
        seq_per_data_shard=MESH_TRAIN_SEQ, steps=MESH_TRAIN_STEPS,
        losses=[st["loss"] for st in runs[0]["steps"]],
        one_device_losses=[st["loss"] for st in ref],
        grad_norms=[st["grad_norm"] for st in runs[0]["steps"]],
        one_device_grad_norms=[st["grad_norm"] for st in ref],
        step_ms_p50=ms[len(ms) // 2],
        one_device_step_ms=[st["ms"] for st in ref],
        collective_ms_per_step=[sum(st["collective_ms"]
                                    for st in run["steps"])
                                / len(run["steps"]) for run in runs],
        tol=MESH_TRAIN_TOL, ranks=runs)
    emit("mesh_train", mesh=label, **out["train"], card=CARD)
    (MESH_WORK / f"train_ref_{label}.pt").unlink(missing_ok=True)
    shutil.rmtree(MESH_SNAPSHOTS / label, ignore_errors=True)
    return out


def mesh_path(torch, dev, cfg, params, prompts):
    """Phase ``mesh``: the kernels at a rank's shapes, the single-device
    eager engine on ``main``'s first prompts and the single-device
    engine of every family cell of ``MESH_CELLS``, then the same traffic
    on each mesh of ``MESH_SHAPES``, two rank processes on the one card
    (``gloo`` through host memory), one spawn a mesh in which each rank
    serves ``main`` with graph segments and then eagerly, then its family
    cells in turn.  Every rank must launch the bit-plane GEMV on its
    decode and tensor-core routes and both paged-attention kernels, run
    ``2 + 2 * layers + 1`` segments a step at ``(1, 2)`` and one at
    ``(2, 1)``, give its eager run's tokens and launches by route with
    graphs, and return the same tokens as every rank, equal to the
    single-device engine's up to near ties; the family cells as
    :func:`mesh_family_checks` says.  Then the slice's cells (PR 27) in
    the same spawn, after the family cells, each against its
    single-device reference (``mesh_slice_refs``, run before the spawn):
    ``mesh_snapshot``, ``mesh_chaos`` (``(1, 2)``), ``mesh_prefill``,
    ``mesh_train``, as :func:`mesh_slice_checks` says.  Returns
    ``main``'s records by mesh, the family cells' and the slice's cells'
    by mesh."""
    mesh_parity(torch, dev)
    prompts = prompts[:MESH_REQUESTS]
    eng, _ = build_engine(torch, dev, cfg, 4, 8, params=params,
                          max_new=MESH_NEW, cuda_graphs=False)
    single, want = serve(torch, "mesh_single", eng, prompts, MESH_NEW)
    del eng
    torch.cuda.empty_cache()
    refs = mesh_references(torch, dev, params)
    want = dict(enumerate(want))
    summary, families, slices = {}, {}, {}
    for shape in MESH_SHAPES:
        label = "x".join(map(str, shape))
        slice_refs = mesh_slice_refs(torch, dev, params, shape, label)
        t0 = time.perf_counter()
        ranks = run_mesh_ranks(shape)
        wall = time.perf_counter() - t0
        graphs0 = ranks[0]["runs"]["graphs"]
        got = dict(enumerate(graphs0["tokens"]))
        # a (1, 2) step's collectives: the vocabulary lookup's sum, wo's
        # and w_down's sums a layer, the logits' gather; none at (2, 1)
        cuts = 2 + 2 * cfg.n_layers if shape[1] > 1 else 0
        for r in ranks:
            g, e = r["runs"]["graphs"], r["runs"]["eager"]
            if g["tokens"] != graphs0["tokens"]:
                raise AssertionError(f"mesh {label}: rank {r['rank']}'s "
                                     "tokens differ from rank 0's")
            if g["tokens"] != e["tokens"]:
                raise AssertionError(f"mesh {label}: rank {r['rank']}'s "
                                     "graph tokens differ from its eager "
                                     "run's")
            if g["route_launches"] != e["route_launches"] or (
                    g["launches"] != e["launches"]):
                raise AssertionError(
                    f"mesh {label}: rank {r['rank']}'s replays launched "
                    f"{g['route_launches']}, its eager steps "
                    f"{e['route_launches']}")
            if not g["cuda_graphs"] or g["segments"] != {
                    "decode": cuts + 1, "prefill": cuts + 1}:
                raise AssertionError(f"mesh {label}: rank {r['rank']}'s "
                                     f"graph segments {g['segments']}, "
                                     f"wanted {cuts + 1} a step")
            routes = route_counts("bitplane_gemv", g["route_launches"])
            if not (routes["decode"] and routes["tensor_core"]
                    and all(g["launches"][k] for k in PAGED_KERNELS)):
                raise AssertionError(f"mesh {label}: rank {r['rank']} "
                                     f"launches {g['launches']} {routes}")
        top = {}
        for key, cand in graphs0["top"].items():
            rid, i = map(int, key.split(":"))
            top[rid, i] = {int(t): v for t, v in cand.items()}
        ties = near_ties(f"mesh_{label}", want, got, top)
        run_keys = (
            "tok_s", "decode_steps", "decode_step_ms", "decode_step_ms_p50",
            "prefill_chunks", "prefill_chunk_ms", "prefill_chunk_ms_p50",
            "collective_ms_per_step", "collective_wait_ms_per_step",
            "collective_share", "peak_mem_gib", "segments",
            "graphs_captured", "capture_s")
        per_rank = [{k: r[k] for k in (
            "rank", "coord", "device", "pool", "lanes", "init_s")}
            | {run: {k: r["runs"][run][k] for k in run_keys}
               for run in ("graphs", "eager")}
            | {k: r["runs"]["graphs"][k] for k in (
                "launches", "route_launches", "gemv_decode_launches",
                "gemv_tensor_core_launches")}
            for r in ranks]
        summary[label] = dict(
            transport=ranks[0]["transport"], layout=ranks[0]["layout"],
            ranks=per_rank, near_ties=ties,
            exact=sum(got[rid] == w for rid, w in want.items()),
            graphs_equal_eager=True, segments_a_step=cuts + 1,
            requests=len(want), wall_s=wall,
            **({"psum8": [r["psum8"] for r in ranks]}
               if "psum8" in ranks[0] else {}))
        emit(f"mesh_{label}", **summary[label],
             single_tok_s=single["tok_s"],
             single_decode_step_ms=single["decode_step_ms"],
             single_prefill_chunk_ms=single["prefill_chunk_ms"], card=CARD)
        families[label] = mesh_family_checks(label, shape, ranks, refs)
        slices[label] = mesh_slice_checks(torch, dev, params, label, shape,
                                          ranks, slice_refs)
    emit("mesh_families", cells=families, card=CARD)
    return summary, families, slices


def mesh_family_launches(families, name):
    """A kernel's launches on every rank of each family cell that runs it
    (by route for the GEMV and its grouped launch), by ``mesh/cell``."""
    out = {}
    for label, cells in families.items():
        for cell, rec in cells.items():
            runs = []
            for r in rec["ranks"]:
                if name.startswith("bitplane_gemv"):
                    grouped = name.endswith("grouped")
                    runs.append({k: v for k, v in r["gemv_routes"].items()
                                 if k.startswith("grouped_") == grouped})
                else:
                    runs.append(r["launches"][name])
            if any(v if isinstance(v, int) else any(v.values())
                   for v in runs):
                out[f"{label}/{cell}"] = runs
    return out


def launch_only(torch, dev, t_start, dry) -> int:
    """``chip_smoke.py --launch``: phase ``launch`` alone after ``env`` and
    ``build``."""
    with Phase("launch"):
        launch_path(torch, dev, dry)
    emit("done", seconds=time.perf_counter() - t_start)
    print(CARD, flush=True)
    return 0


def mesh_only(torch, dev, t_start) -> int:
    """``chip_smoke.py --mesh``: phase ``mesh`` alone after ``env`` and
    ``build``, on params drawn as ``main`` draws them."""
    from repro_torch.models import init_params

    with Phase("mesh"):
        cfg = full_config()
        prompts = prompts_for(cfg, 16, 33, 300, SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(cfg, gen, engine_bits=4)
        mesh_path(torch, dev, cfg, params, prompts)
    emit("done", seconds=time.perf_counter() - t_start)
    print(CARD, flush=True)
    return 0


# ----------------------------------------------------------- launch phase
# the cells of ``repro_torch.launch.steps`` on the card, each at the shape
# an earlier phase runs: (name, arch, kind, seq_len, batch, cell options)
LAUNCH_CELLS = [
    ("prefill", "qwen2.5-3b", "prefill", 4096, 2, {}),              # long
    ("chunked_prefill", "qwen2.5-3b", "prefill", 1024, 8,           # main
     {"chunked": True}),
    ("paged_serve", "qwen2.5-3b", "decode", 1024, 8, {"paged": True}),
    ("serve", "qwen2.5-3b", "decode", 1024, 8, {}),
    ("train", "qwen2.5-3b", "train", 1024, 2, {}),                  # train
    ("ssm_prefill", "mamba2-130m", "prefill", 4096, 4, {}),         # ssm
]
LAUNCH_TIMED = 3             # timed calls a cell (p50), after one warm-up
LAUNCH_BOUND_SLACK = 1.05    # a cell faster than its bound by more fails
LAUNCH_ARG_RTOL = 0.02       # the card's argument bytes against the count
# the dry records: a rank of (16, 16), and one of (2, 16, 16)
LAUNCH_DRY = [
    ("qwen2.5-3b", "decode_32k",
     ["--paged", "--engine-bits", "4", "--kv-bits", "8"]),
    ("qwen2.5-3b", "prefill_32k", ["--chunked-prefill"]),
    ("qwen2.5-3b", "train_4k", []),
    ("mamba2-130m", "long_500k", []),
    ("llama4-scout-17b-a16e", "decode_32k",
     ["--paged", "--engine-bits", "4", "--multi-pod"]),
]
LAUNCH_DRY_DIR = ROOT / "build" / "dryrun"
LAUNCH_DRY_TIMEOUT = 600
_DRY_PROGRAM = """
import json, sys
import torch
from repro_torch.launch.dryrun import main
torch.set_num_threads(1)
for argv in json.loads(sys.argv[1]):
    main(argv)
"""


class DryRuns:
    """The dry records of ``LAUNCH_DRY``, counted on the host's CPU in one
    background process (no CUDA device visible to it, one thread, the
    lowest priority, so that it takes little from the phases' host work)
    while the card runs the earlier phases; :meth:`records` waits for it.
    Stopped at exit if it still runs."""

    def __init__(self):
        import atexit
        import os

        LAUNCH_DRY_DIR.mkdir(parents=True, exist_ok=True)
        argvs = [["--arch", arch, "--shape", shape, *flags,
                  "--out", str(LAUNCH_DRY_DIR)]
                 for arch, shape, flags in LAUNCH_DRY]
        self.log_path = LAUNCH_DRY_DIR / "launch_dry.log"
        self.log = open(self.log_path, "w")
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _DRY_PROGRAM, json.dumps(argvs)],
            stdout=self.log, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
            preexec_fn=lambda: os.nice(19))
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()

    def records(self):
        rc = self.proc.wait(timeout=LAUNCH_DRY_TIMEOUT)
        self.log.close()
        text = self.log_path.read_text()
        if rc != 0:
            raise AssertionError(f"launch_dry: the dry runs exited {rc}:\n"
                                 f"{text[-3000:]}")
        paths = [ln.split("wrote ", 1)[1].strip()
                 for ln in text.splitlines() if ln.startswith("wrote ")]
        if len(paths) != len(LAUNCH_DRY):
            raise AssertionError(f"launch_dry: {len(paths)} records of "
                                 f"{len(LAUNCH_DRY)}:\n{text[-3000:]}")
        return [json.loads((ROOT / p).read_text()) for p in paths]


def launch_counts_equal(name, card, meta):
    """The count on the card and on ``meta`` must be equal, to the unit."""
    for key in ("flops", "bytes", "transcendentals", "collectives",
                "priced"):
        if card[key] != meta[key]:
            raise AssertionError(f"launch {name}: {key} counted on the card "
                                 f"{card[key]} and on meta {meta[key]}")


def launch_path(torch, dev, dry):
    """Phase ``launch``: every cell of ``LAUNCH_CELLS`` built by
    ``repro_torch.launch.steps.build_cell(abstract=False)`` on a
    ``make_host_mesh()`` ``(1, 1)``: one warm-up call, three timed (p50),
    one counted under the op counter on the card and one on ``meta``
    (equal, to the unit), its kernel launches (``_build`` counts over the
    counted call) equal to its priced calls by route, its bound
    (``roofline_report`` with ``HW_H100``) no more than 1.05x its time,
    and its argument bytes on the card within 2% of the count's.  Then the
    dry records (``DryRuns``)."""
    from repro_torch.config import (EngineConfig, RunConfig, ServeConfig,
                                    ShapeConfig, TrainConfig)
    from repro_torch.dist.hints import dry_mesh
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, cache_bytes
    from repro_torch.roofline import (HW_H100, counted_costs,
                                      model_bytes_for_cell,
                                      model_flops_for_cell, roofline_report)

    mesh = make_host_mesh(device=dev)
    meta = dry_mesh((1, 1), ("data", "model"))
    eng = EngineConfig(weight_bits=4, kv_bits=8)
    out = {}
    for name, arch, kind, seq, batch, kw in LAUNCH_CELLS:
        cfg = arch_config(arch)
        shape = ShapeConfig(f"launch_{name}", kind, seq, batch)
        run = RunConfig(model=cfg, shape=shape,
                        train=TrainConfig(remat="block", microbatches=2),
                        serve=ServeConfig(engine=eng, page_size=16,
                                          prefill_chunk=32))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn, args, _ = build_cell(run, mesh, abstract=False, device=dev,
                                 seed=SEED, **dict(kw))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        arg_bytes = torch.cuda.memory_allocated() - base
        fn(*args)
        torch.cuda.synchronize()
        times = []
        for _ in range(LAUNCH_TIMED):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = sorted(times)[len(times) // 2] * 1e3
        before = (dict(_build.LAUNCHES), dict(_build.ROUTE_LAUNCHES))
        torch.cuda.reset_peak_memory_stats()
        card = counted_costs(fn, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        kernels = {k: v - before[0][k] for k, v in _build.LAUNCHES.items()
                   if v != before[0][k]}
        routes = {k: v - before[1][k]
                  for k, v in _build.ROUTE_LAUNCHES.items()
                  if v != before[1][k]}
        del fn, args
        torch.cuda.empty_cache()
        mfn, margs, _ = build_cell(run, meta, abstract=True, **dict(kw))
        on_meta = counted_costs(mfn, *margs)
        del mfn, margs
        launch_counts_equal(name, card, on_meta)
        priced = card["priced"]
        want_kernels = {}
        for key, n in priced.items():
            kernel = key.split("/")[0]
            want_kernels[kernel] = want_kernels.get(kernel, 0) + n
        want_routes = {k: n for k, n in priced.items()
                       if k in _build.ROUTE_LAUNCHES}
        if kernels != want_kernels or routes != want_routes:
            raise AssertionError(f"launch {name}: launches {kernels} / "
                                 f"{routes} against priced calls {priced}")
        bits = 0 if kind == "train" else eng.weight_bits
        report = roofline_report(
            card, 1, model_flops=model_flops_for_cell(cfg, shape),
            model_bytes=model_bytes_for_cell(
                cfg, shape, bits, cache_bytes(run, kind, **dict(kw))),
            hw=HW_H100)
        bound_ms = report["bound_seconds"] * 1e3
        if bound_ms > LAUNCH_BOUND_SLACK * ms:
            raise AssertionError(f"launch {name}: {ms} ms measured, faster "
                                 f"than its bound of {bound_ms} ms: the "
                                 "count is wrong")
        mem = card["memory_analysis"]
        argument = mem["argument_size_in_bytes"]
        if abs(arg_bytes - argument) > LAUNCH_ARG_RTOL * argument:
            raise AssertionError(f"launch {name}: {arg_bytes} argument bytes "
                                 f"on the card against {argument} counted")
        rec = dict(
            cell=name, model=cfg.name, layers=cfg.n_layers, kind=kind,
            seq=seq, batch=batch, options=kw, build_s=build_s, ms=ms,
            times_ms=[t * 1e3 for t in times], bound_ms=bound_ms,
            dominant=report["dominant"],
            compute_ms=report["compute_s"] * 1e3,
            memory_ms=report["memory_s"] * 1e3,
            collective_ms=report["collective_s"] * 1e3,
            roofline_fraction=report["roofline_fraction"],
            bound_over_ms=bound_ms / ms, flops=card["flops"],
            bytes=card["bytes"], priced=priced, launches=kernels,
            route_launches=routes, regions=card["regions"],
            count_s_card=card["count_s"], count_s_meta=on_meta["count_s"],
            argument_bytes_card=arg_bytes, memory=mem,
            peak_minus_arguments=peak - arg_bytes, card=CARD)
        emit("launch_cell", **rec)
        out[name] = rec
        torch.cuda.empty_cache()
    dry_recs = []
    for r in dry.records():
        keep = dict(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                    kind=r["kind"], compute_s=r["compute_s"],
                    memory_s=r["memory_s"], collective_s=r["collective_s"],
                    dominant=r["dominant"],
                    roofline_fraction=r.get("roofline_fraction"),
                    collectives=r["collective_bytes_per_device"],
                    memory=r["memory_analysis"], priced=r["priced"],
                    count_s=r["count_s"])
        emit("launch_dry", **keep)
        dry_recs.append(keep)
    emit("launch_summary", cells=list(out), dry=len(dry_recs),
         dry_wall_s=time.perf_counter() - dry.t0, card=CARD)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in
    torch.backends.cudnn.allow_tf32 = False         # full float32
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    global CARD
    with Phase("env"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        CARD = smi
        emit("env", python=sys.version.split()[0], torch=torch.__version__,
             cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=smi,
             peaks=dict(hbm_bytes_s=PEAK_HBM_BYTES_S, ops_s=PEAK_OPS_S))

    with Phase("build"):
        from repro_torch.kernels import _build

        info = _build.build()
        regs = [ln.split(":", 1)[-1].strip()
                for ln in str(info["log"]).splitlines()
                if "registers" in ln or ("spill" in ln
                                         and "0 bytes spill stores" not in ln)]
        emit("build", seconds=info["seconds"], library=str(info["path"]),
             log=str(_build.BUILD_DIR / "build.log"), ptxas=regs)

    if sys.argv[1:] == ["--mesh"]:
        return mesh_only(torch, dev, t_start)
    # the dry records need no card: counted meanwhile, on the host's CPU
    dry = DryRuns()
    if sys.argv[1:] == ["--launch"]:
        return launch_only(torch, dev, t_start, dry)

    with Phase("parity"):
        gemv_parity(torch, dev)
        grouped_parity(torch, dev)
        attn_parity(torch, dev)
        prefill_head_dim_parity(torch, dev)
        decode_split_parity(torch, dev)
        flash_parity(torch, dev)
        ssd_parity(torch, dev)
        int8_parity(torch, dev)

    with Phase("time"):
        gemv_rows = [gemv_time(torch, dev, m, k, n)
                     for m in (8, 256) for (k, n) in GEMV_SHAPES]
        attn_rows = {(kind, mode): attn_time(torch, dev, kind, mode)
                     for kind in ("int8", "bfloat16")
                     for mode in ("decode", "prefill")}
        # the full-sequence decode steps' GEMVs: M = 2 (long), 4 (ssm)
        gemv_rows += [gemv_time(torch, dev, 2, k, n) for (k, n) in
                      GEMV_SHAPES]
        gemv_rows += [gemv_time(torch, dev, 4, k, n) for (k, n) in
                      SSM_GEMV_SHAPES]
        # the one-shot prefills' GEMVs: M = 2 x 4096 (long), 4 x 4096 (ssm)
        gemv_rows += [gemv_time(torch, dev, 8192, k, n)
                      for (k, n) in GEMV_SHAPES]
        for (k, n) in SSM_GEMV_SHAPES:
            gemv_time(torch, dev, 16384, k, n)
        flash_rec = flash_time(torch, dev)
        # past the tiles' head dims: flash attention's wide route (bf16,
        # D 320) and the chunked prefill's CUDA-core route (int8 pools)
        flash_time(torch, dev, d=320)
        attn_time(torch, dev, "int8", "prefill", dh=320)
        ssd_rec = ssd_time(torch, dev)
        # bit-serial at 8 (radix 1, 2) and 2 bits against the bit-parallel
        # baseline, beside the 4-bit rows above
        for bits, radix in ((8, 1), (8, 2), (2, 1)):
            for (k, n) in GEMV_SHAPES:
                gemv_time(torch, dev, 8, k, n, bits=bits, radix=radix)
        int8_rows = [int8_time(torch, dev, m, k, n)
                     for m in (1, 8, 256, 8192) for (k, n) in GEMV_SHAPES]
        # the MoE experts' linears through the grouped launch, at a decode
        # step (8 lanes routed) and a chunk (every expert at 64 rows)
        grouped_rows = [grouped_time(torch, dev, k, n, e, top_k, mode)
                        for (k, n, e, top_k) in GROUPED_SHAPES
                        for mode in ("decode", "chunk")]
        torch.cuda.empty_cache()

    with Phase("main"):
        cfg = full_config()
        prompts = prompts_for(cfg, 16, 33, 300, SEED)
        eng, params = build_engine(torch, dev, cfg, 4, 8)
        main_rec, main_tokens = serve(torch, "main", eng, prompts, 32)
        profile_rec = profile_decode_steps(
            torch, eng, prompts_for(cfg, 8, 33, 300, SEED + 20))
        del eng
        torch.cuda.empty_cache()
        # the same prompts once more with every step eager
        graphs_against_eager(torch, dev, "main", cfg, 4, 8, prompts, 32,
                             params=params, graph_rec=main_rec,
                             graph_tokens=main_tokens)
        torch.cuda.empty_cache()

    with Phase("prefix"):
        hot_rec, hot_tok = prefix_path(torch, dev, cfg, params, prompts,
                                       main_rec, main_tokens)

    with Phase("obs"):
        obs_path(torch, dev, cfg, params, prompts, main_rec, main_tokens)

    with Phase("chaos"):
        chaos_path(torch, dev, cfg, params, hot_rec, hot_tok)

    with Phase("snapshot"):
        snapshot_path(torch, dev, cfg, params, prompts, main_tokens,
                      hot_rec, hot_tok)
        torch.cuda.empty_cache()

    with Phase("mesh"):
        mesh_rec, mesh_fam, mesh_slice = mesh_path(torch, dev, cfg, params,
                                                   prompts)
        del params
        torch.cuda.empty_cache()

    with Phase("dense"):
        dense_path(torch, dev)

    with Phase("moe"):
        moe_rec = moe_path(torch, dev)

    with Phase("families"):
        families_path(torch, dev)

    with Phase("second"):
        cfg = full_config(n_layers=4)
        eng, _ = build_engine(torch, dev, cfg, 8, 0)
        serve(torch, "second", eng, prompts_for(cfg, 16, 33, 300, SEED + 1),
              32)
        del eng
        torch.cuda.empty_cache()

    with Phase("whole"):
        whole_path_check(torch, dev)

    with Phase("long"):
        long_rec = long_path(torch, dev)
        torch.cuda.empty_cache()

    with Phase("ssm"):
        ssm_rec = ssm_path(torch, dev)
        torch.cuda.empty_cache()

    with Phase("long_whole"):
        long_whole_check(torch, dev)

    with Phase("slots"):
        slots_path(torch, dev)

    with Phase("train"):
        train_path(torch, dev)

    with Phase("layouts"):
        layouts_path(torch, dev)

    with Phase("launch"):
        launch_rec = launch_path(torch, dev, dry)

    with Phase("engine"):
        engine_rec = engine_path(torch, dev)

    def row(rows, m):      # w_gate/w_up at M = m
        return next(r for r in rows
                    if r["m"] == m and (r["k"], r["n"]) == GEMV_SHAPES[2])

    # the tensor-core route of both GEMVs at the long prefill's and the
    # paged prefill chunk's M, with its launches on each kernel's own path:
    # the long prefill and main's prefill chunks for the bit-plane GEMV, the
    # engine path (M = 1, so none) for the int8 baseline
    tc_launches = {
        ("bitplane_gemv", 8192): (
            long_rec["prefill_gemv_routes"]["tensor_core"], "long prefill"),
        ("bitplane_gemv", 256): (main_rec["gemv_tensor_core_launches"],
                                 "main prefill chunks"),
        ("int8_matvec", 8192): (engine_rec["int8_routes"]["tensor_core"],
                                "engine"),
        ("int8_matvec", 256): (engine_rec["int8_routes"]["tensor_core"],
                               "engine")}
    prefill = {
        name: [dict(m=m, k=r["k"], n=r["n"], linear=r["linear"],
                    gemv_route=r["gemv_route"],
                    source="src/repro_torch/csrc/tc_gemm.cuh",
                    launches=tc_launches[name, m][0],
                    launches_in=tc_launches[name, m][1],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for m in (8192, 256) for r in (row(rows, m),)]
        for name, rows in (("bitplane_gemv", gemv_rows),
                           ("int8_matvec", int8_rows))}
    reps = {"bitplane_gemv": next(r for r in gemv_rows if r["m"] == 8
                                  and (r["k"], r["n"]) == GEMV_SHAPES[2]),
            "paged_decode_attention": attn_rows[("int8", "decode")],
            "paged_prefill_attention": attn_rows[("int8", "prefill")],
            "flash_attention": flash_rec, "ssd_scan": ssd_rec,
            "int8_matvec": next(r for r in int8_rows if r["m"] == 8
                                and (r["k"], r["n"]) == GEMV_SHAPES[2]),
            "bitplane_gemv_grouped": grouped_rows[0]}
    shapes = {"bitplane_gemv": "decode w_gate/w_up: M=8, K=2048, N=11008, "
                               "4-bit, bf16",
              "paged_decode_attention": "decode: 8 lanes, 41-332 keys, "
                                        "int8 pools, G=8, Dh=128, page 16",
              "paged_prefill_attention": "prefill chunk: 8 lanes x 32, "
                                         "int8 pools, G=8, Dh=128, page 16",
              "flash_attention": "prefill: B=2, S=4096, Hq=16, Hkv=2, "
                                 "D=128, bf16, causal",
              "ssd_scan": "prefill: B=4, S=4096, H=24, P=64, N=128, "
                          "chunk 256, bf16 inputs",
              "int8_matvec": "M=8, K=2048, N=11008, bf16 x and output",
              "bitplane_gemv_grouped": "llama4 w_gate/w_up decode: 16 "
                                       "experts, 8 lanes routed top-1, "
                                       "K=5120, N=8192, 4-bit, bf16"}
    # launches on each kernel's own path: paged serving (main) for the
    # first three, the one-shot prefills of long and ssm for flash and the
    # SSD scan, the engine path for the int8 baseline
    launches = dict(main_rec["launches"])
    launches["flash_attention"] = long_rec["prefill_launches"][
        "flash_attention"]
    launches["ssd_scan"] = ssm_rec["prefill_launches"]["ssd_scan"]
    launches["int8_matvec"] = engine_rec["launches"]["int8_matvec"]
    # the grouped launch on its own path: phase moe's llama4-scout run
    moe_main = moe_rec[MOE_CASES[0][0]]
    launches["bitplane_gemv_grouped"] = sum(
        moe_main["grouped_routes"].values())
    # the same paths' launches by route, for the kernels with routes
    path_routes = {
        "bitplane_gemv": route_counts("bitplane_gemv",
                                      main_rec["route_launches"]),
        "paged_prefill_attention": route_counts(
            "paged_prefill_attention", main_rec["route_launches"]),
        "flash_attention": long_rec["prefill_flash_routes"],
        "int8_matvec": engine_rec["int8_routes"],
        "bitplane_gemv_grouped": moe_main["grouped_routes"]}
    kernels = []
    for name, meta in KERNELS.items():
        rep = reps[name]
        kernels.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            shape=shapes[name],
            **({"routes": path_routes[name]} if name in path_routes else {}),
            **({"timed_route": rep.get("route", rep.get("gemv_route"))}
               if "route" in rep or "gemv_route" in rep else {}),
            **({"ms_per_main_decode_step":
                profile_rec["port_kernels_ms_per_step"][name]}
               if name in profile_rec.get("port_kernels_ms_per_step", {})
               else {}),
            **({"prefill": prefill[name]} if name in prefill else {}),
            **({"mesh_launches": {
                label: [r["launches"][name] for r in rec["ranks"]]
                for label, rec in mesh_rec.items()}}
               if name in PAGED_KERNELS else {}),
            **({"mesh_family_launches": mesh_family_launches(mesh_fam,
                                                             name)}
               if name in PAGED_KERNELS + ("bitplane_gemv_grouped",)
               else {}),
            **({"mesh_prefill_launches": {
                f"{label}/{cell}": [r["launches"][name] for r in
                                    rec["ranks"]]
                for label, recs in mesh_slice.items()
                for cell, rec in recs["prefill"].items()
                if rec["ranks"][0]["launches"][name]}}
               if name in ("flash_attention", "ssd_scan") else {}),
            **({"launch_launches": {
                cell: rec["launches"][name]
                for cell, rec in launch_rec.items()
                if rec["launches"].get(name)}}
               if name != "bitplane_gemv_grouped" else {}),
            **({"grouped": [{k: r[k] for k in (
                "linear", "mode", "k", "n", "experts", "touched", "rows",
                "gemv_route", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")} for r in grouped_rows]}
               if name == "bitplane_gemv_grouped" else {})))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank_main(sys.argv))
    sys.exit(main())
