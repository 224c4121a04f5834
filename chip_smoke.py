#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the repository root, one GPU
    python3 chip_smoke.py --timing-of DIR  # the timing phase alone, on DIR
    python3 chip_smoke.py --group          # build, train_mesh (4 GPUs),
                                           # stream's multi-card part,
                                           # dist and group alone (on 2-4
                                           # GPUs: shards and ranks over
                                           # the cards)

Phases (one line each; any failing phase makes the script exit non-zero):

1. build    — both CUDA sources with nvcc from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, started together); prints the
              build seconds, ptxas' registers / stack / spills of each of
              the six instantiations (fused whole-grid and halo entries,
              prepass; int32 and int64), the launch shape, shared memory
              and resident blocks per SM the runtime reports, and
              ``nvidia-smi --query-gpu=name,power.limit``.
2. kernels  — the fused and prepass kernels bit-equal to the plain PyTorch
              version on the card (tolerance 0: all outputs are integers)
              over asymmetric, thin, 2-D and 1-D grids, int32 and int64
              ranks, 127^3 (packed-key grid) and 128^3 (first column-key
              grid), a batch of 3, 256^3, and the edges of the kernels'
              128-vertex tiles: dims that are no multiple of it, nx = ny =
              1, batches of 3 whose tiles cross a member's end, and int64
              ranks above 2^31.  Then the fused kernel's halo entry on the
              (nzl+2, ny, nx) key volumes of streamed chunks (int64
              (value, vid) keys), bit-equal to the plain version and to
              the whole-grid fused rows of the same slab under
              ``vertex_order``: first, interior and last chunks of 256^3,
              a chunk that is the whole grid (two -1 ghosts), nzl = 1,
              nx = ny = 1, ragged (129, 7, 5) slabs, many tied values and
              keys above 2^62.  And its int32 instantiation on the
              dense-rank ext volumes of a block ring, as the distributed
              front-end feeds it (first block with a -1 ghost below, a
              middle one, the last with a -1 ghost above): ``isabel``
              256^3 in 8 blocks, 64x48x40 in 8, odd shapes (3 blocks of
              33x17x3, 20 one-plane blocks, nx = ny = 1, ragged 129x7).
3. main     — the main path: ``PersistencePipeline().run`` on ``isabel``
              256^3 and ``random`` 128^3 through the ``fused`` kernel, and
              the ``prepass`` backend on ``random`` 128^3 as its
              cross-check, plus ``run_batch`` of 3 same-shape fields.  The
              launch counters are zeroed just before and read just after;
              both kernels must have launched and the plain version must
              not have run on the card.  Gradient check: the critical
              counts have Euler characteristic 1 and match the diagram;
              then ``check_gradient_valid`` on the 256^3 gradient.
4. stream   — the streamed path: ``diagram_stream(ArraySource)`` on
              ``isabel`` 256^3 with ``chunk_z=32`` (8 chunks), its payload
              byte-equal to the in-memory main-path result of phase 3, its
              ``StreamReport`` and peak device memory, with the launch
              counters zeroed just before and read just after (the halo
              entry launched once per chunk, the plain version never);
              the sharded engine (4 shards, ``distributed=False``) on
              ``random`` 128^3 end to end (payload equal to phase 3's) and
              on ``isabel`` 256^3 front-end only (gradient and keys equal
              to ``stream_front``'s); and out of core, ``stream_front``
              over ``FunctionSource.synthetic("random", 512^3)`` with the
              default 64 MiB chunk budget (critical counts with Euler
              characteristic 1).  On a host with two cards or more, shard
              s runs on card s % N: one child process per card count (1,
              2 and, with four cards, 4; CUDA_VISIBLE_DEVICES names the
              first cards) logs the halo entry's attributes on each card,
              repeats the two 4-shard runs above on 2 or more cards
              (payload, gradient and keys equal to the one-card runs),
              and times a ``MemmapSource`` of ``random`` 512^3 (512 MiB
              written once, its page-cache share logged) through 4 shards
              with the 64 MiB budget: wall, load, compute, scatter and
              halo seconds, the overlap fraction, each card's peak, the
              bytes between cards, the largest cube whose gradient and
              keys fit the home card; every run with each shard on the
              card ``per_shard`` names, at most two chunks resident a
              shard and the halo entry once per chunk, and the critical
              counts equal across card counts.  With one card a line says
              the multi-card part did not run.  Nothing here is caught.
5. dist     — the distributed engines on the one card, every block on
              it (``LocalRing``): ``run_front`` on ``isabel`` 256^3 in 8
              blocks through the halo entry, with the sample sort (int32
              ranks; the slack doubled while a bucket overflows, logged)
              and with rank-free keys: no overflow, nothing unresolved,
              ranks equal to ``vertex_order``, critical counts and the D0
              and dual triplet sets equal to the in-memory front-end's
              (``build_d0_graph`` / ``build_dual_graph_chase`` on the fused
              gradient); ``prepass`` with ``overlap_comm`` on and off at
              128^3 (equal); the ``shardmap`` backend at 256^3
              (``homology_dims=(0,)``), payload equal to ``fused``'s;
              ``pairing_fixpoint`` on the 256^3 D0 and dual graphs, equal
              to ``pair_extrema_saddles_kernel``; and the whole
              ``distributed=True`` path on ``random`` 32^3 and ``isabel``
              64^3 in 8 blocks (the host token D1 bounds the size),
              payloads equal to the sequential runs'.  Per-step seconds
              (each ending in a synchronize), ring rotations, bucket peak,
              buffer sizes and peak device memory are logged; the launch
              counters are zeroed before the distributed runs and read
              after (halo entry 24, prepass 32, fused 2, the plain
              version 0).
6. group    — the front-end over a ``torch.distributed`` process group:
              a one-rank NCCL group (``file://`` rendezvous) whose
              ``GroupRing`` (``block_ring``) holds all 8 blocks: (a)
              ``run_front`` on ``isabel`` 256^3 through the halo entry,
              sample-sorted (int32) and rank-free (int64), every output
              equal to phase 5's ``LocalRing`` outputs, seconds beside
              phase 5's; (b) the ``shardmap`` backend's rows at 256^3
              equal to the ``fused`` backend's; (c) ``distributed=True``
              ``shardmap`` at ``isabel`` 64^3, payload equal to the same
              run without a group.  Launch counters zeroed just before
              the group's runs and read just after (halo entry 32, no
              other kernel, the plain version never); the group is
              destroyed before phase 13 opens its fake one.  On a host
              with two cards or more, one rank per card repeats (a) and
              (c) with 8 blocks: 2 NCCL ranks (4 blocks each), 4 NCCL
              ranks on four cards, and 2 ranks of a device-mapped
              ``cpu:gloo,cuda:nccl`` group; rank 0's outputs equal to a
              ``LocalRing`` run on its card, every other rank's equal to
              rank 0's by a SHA-256 of each array, and every group's equal
              to the 2 NCCL ranks'.  The 2-rank groups also hold
              ``allreduce_compressed`` over NCCL to gloo's result (a gloo
              subgroup, the device-mapped group's CPU side) bit for bit.
              Then ``examples/distributed_pd_torch.py`` under ``torchrun``
              on 2 cards (NCCL, 32^3, ``--stream``).  With one card a line
              says so.
7. approx   — approximation at ``isabel`` 256^3: the ``Hierarchy`` on
              the card (levels, dims and bounds equal to the CPU's; the
              level-1 ``block_minmax`` and the cascade timed beside their
              byte bounds and beside ``max_pool3d``), ``approximate`` at
              each of the 7 coarse levels with the bottleneck guarantee
              checked against the exact 256^3 diagram of phase 3 for the
              dimensions whose pair counts fit GUARANTEE_BUDGET (the rest
              logged as skipped), and in full on ``wavelet`` 64^3;
              ``epsilon`` picks the expected level; ``refine`` under a
              deadline and to the end at 128^3 (equal to ``run`` of the
              progressive request); a ``MemmapSource`` of the field at
              level 1 through the halo entry, equal to the in-memory
              payload.  Launch counters zeroed just before and read just
              after: the fused kernel once per level, the plain version
              never on the card.
8. serve    — ``TopoService(cache=True)`` on the card: four same-shape
              64^3 fields from client threads in one batched dispatch
              (equal to ``run``), resubmitted as cache hits that launch no
              kernel, a progressive 256^3 submit with ``deadline_s``
              (preview first), a later ``epsilon`` submit served from the
              refined entry, a traced request (one span per stage), a
              ``wire=True`` payload, and ``stats_payload``.
9. cpu      — diagrams on the card equal those on the CPU (32^3 wavelet,
              32^3 random, a thin 2-D grid).
10. oracle  — the card's kernels against the numpy oracles: fused and
              prepass rows byte-equal to literal Robins on the host (and
              the scattered gradients equal) on ``random``, ``wavelet``
              and ``isabel`` 16^3 (``isabel`` also in the masked form)
              and two odd shapes; the diagrams of ``fused``,
              ``prepass``, ``diagram_stream`` (the halo entry, >= 2
              chunks in 3-D) and the ``np`` gradient with the ``np``
              sandwich equal to the boundary-matrix reduction
              (``compute_oracle``: off-diagonal points and essential
              orders) on tests/test_dms.py's 1-D, 2-D and 3-D cases,
              ``random`` 32^3 (no np/np: literal Robins takes ~2 ms a
              vertex) and ``isabel`` 16^3; ``fused`` with the ``np``
              sandwich at 32^3 (``random``, ``isabel``), arrays equal to
              the ``torch`` sandwich's; ``compile`` twice (the second
              hits the plan cache), ``diagram`` / ``diagrams`` equal to
              ``run``, ``StageReport.to_dict`` through JSON.  One line
              per check with both sides' seconds; launch counters zeroed
              just before and read just after (every kernel launched,
              the plain version never).
11. lm      — the LM substrate's serving path (``repro_torch.models``,
              ``repro_torch.configs``, ``repro_torch.serve.generate``):
              the ten smoke architectures on the card against the CPU from
              one seeded parameter tree (``lm_apply`` logits and aux, two
              ``decode_step``s with every cache leaf, a greedy ``generate``
              of 8 tokens); one model per mixer family at full published
              width, one at a time (minitron-4b dense GQA and mamba2-2.7b
              SSM, all their layers; minicpm3-4b MLA decoding naive and
              absorbed, cut to 16 of its 62 layers; moonshot-v1-16b-a3b
              MoE cut to 4 of its 48 layers):
              seeded parameters made on the card, ``generate`` of 32 greedy
              tokens for 4 prompts of 64 seeded tokens, parameter bytes,
              prefill and decode seconds, decode tokens per second, peak
              device memory and the device's time and busy share over 4
              decode steps (``torch.profiler``'s device events), with
              prefill by decode steps held against ``lm_apply(prompts)[:,
              -1]`` in f32 compute and, in bf16, against the f32 forward,
              the cache leaves' dtypes checked, and control readings of
              those checks with a known fault injected (each must be
              caught); and the reference's jnp device
              programs, ported as torch ops, timed with CUDA events beside
              their bounds: ``_flash_sdpa`` at minitron-4b's attention (S =
              4096, causal; against ``_sdpa``, beside
              ``scaled_dot_product_attention``), ``ssd_chunked`` at
              mamba2-2.7b's (S = 4096, chunk 256; against the recurrence
              token by token) and one ``moe`` layer of moonshot at B*S =
              4096 (against a loop over experts).  Tolerances are stated
              beside LM_ATOL.  No hand-written kernel runs here.
12. train   — the LM substrate's training (``repro_torch.data``,
              ``repro_torch.train``, ``repro_torch.launch``): the ten
              smoke architectures' train-step gradients on the card
              against the CPU from one seeded tree, microbatches=2 and
              remat against the card's own plain gradient, one AdamW step
              on each device; the restart of ``run`` bit for bit on the
              card under deterministic algorithms (10 steps against 5, a
              crash and a resume, every parameter and moment) and a
              checkpoint of it read back onto the CPU; h2o-danube-3-4b
              (dense GQA with a 4096 window, 24 layers) and mamba2-2.7b
              (SSM, 64 layers) trained at full width and depth, B 1 x S
              4096 with remat, 4 steps on one batch (the loss must fall),
              with a directional-derivative check in f32 compute at step
              0, the static bytes, peak device memory, seconds per step
              (the first apart), tokens per second and the device's busy
              share over a profiled step; the backward passes of
              ``_flash_sdpa`` (against ``_sdpa``'s, beside
              ``scaled_dot_product_attention``'s) and ``ssd_chunked`` at
              those shapes beside their bounds; and the topology monitor
              of ``examples/train_topo_monitor_torch.py`` (a 16 x 16 loss
              landscape) through ``TopoService`` on the fused kernel,
              its diagram equal to the ``np`` back-end's, its launches
              counted (zeroed just before, read just after) and its
              re-check a cache hit that launches nothing; and the ten
              smoke architectures' step 0 through the ``DTensor`` path on
              a (data=1, model=1) ``DeviceMesh`` over a one-rank NCCL
              group (``file://`` rendezvous; parameters placed by
              ``param_shardings``, the batch by ``batch_spec``), loss and
              every gathered gradient leaf held to the plain step on the
              card, the group destroyed before phase 13.  Tolerances are
              stated beside TRAIN_LOSS_RTOL.
13. plan    — multi-device planning (``repro_torch.launch.{mesh,
              roofline, dryrun}``, ``repro_torch.train.sharding``): the
              planner on this host for every architecture at
              ``train_4k`` on the (data=16, model=16) mesh and the DDMS
              fields (``paper_6b``, ``strong_512``) on both field meshes,
              one line per cell (per-device bytes, the three roofline
              terms on the H100 model, the dominant one, the useful
              ratio); [train]'s two full-width steps planned at mesh (1,
              1): static bytes equal to the card's to the byte, the
              planned peak within PLAN_PEAK_RTOL of the steps'
              ``max_memory_allocated`` and its part above the static
              bytes within PLAN_DYNAMIC_RTOL, the counted FLOPs beside the
              profiler's device ms per step; a smoke step counted on fake
              CUDA and CPU tensors (equal FLOPs); the DDMS plan of
              [dist]'s ``run_front`` (at its sort slack) within
              PLAN_PEAK_RTOL of that run's own peak (less what lay on the
              card before it, logged apart) and beside its tet passes'
              seconds; and one block of the paper's 2048 x 1920 x 1536
              field in 256 blocks (6 owned planes and 2 ghosts, a
              generated stand-in) through the halo entry's int32
              instantiation, its launch counted, its rows equal to the
              plain version's (timed) and to the fused in-memory
              entry's, timed beside its bound.
14. timing  — CUDA-event times of ``fused`` and ``prepass`` at 256^3
              (``isabel``, ``random``) and 512^3 (``random``) and of the
              plain version at 256^3, each beside its bound (the longer of
              its bytes over 3.35 TB/s and the integer operations the
              pairing needs on this run's data over 33.5 T/s), the pops
              per vertex and the warp divergence factor of that data; and
              the halo entry per chunk of ``isabel`` 256^3 (int64 keys,
              ``chunk_z=32``) and over the whole grid, beside its bound
              (8 B read and 153 B written per owned vertex plus the ghost
              planes) and the plain version's time on the same chunks.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script prints no result and exits non-zero.

``--group`` runs only the build, ``[train_mesh]`` (below, with phase
13's mesh plans held to it), phase 4's multi-card part, phase 5 (and
phase 13's DDMS peak held to it) and phase 6 (every part even where one
before it failed; then it exits 1 naming them); it prints no result
lines.  ``[train_mesh]`` (four cards): minitron-4b at its published width
and depth, whose training state (81.5 GB) fits no one card, trained on 4
NCCL ranks, one per card, on the (data=2, model=2) and (data=1, model=4)
meshes (``init_placed`` parameters, B 2 x S 4096, remat, 4 AdamW steps):
per rank the static bytes, the peak over the steps, first and steady
seconds per step, tokens per second, losses and gradient norm beside
``nvidia-smi``'s name and power limit; the loss finite, falling and the
same on every rank; step 0's loss, every gradient leaf (gathered to
rank 0 one at a time) and the gradient norm held to a one-card reference
(card 0 alone, microbatches=2); and ``plan_cell`` at each mesh
held to every rank (static bytes equal, peak within PLAN_PEAK_RTOL).

``--timing-of DIR`` runs only phase 14 (without the plain version) on the
port in another tree DIR, for instance the parent commit unpacked with
``git archive`` into a git-ignored directory; it prints no result lines.
To compare two trees, time them in turns in one call on one card (A, B,
B, A).
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# operation and byte counts of one lower-star pairing launch
# --------------------------------------------------------------------------

def _roofline():
    """The port's hardware model (``repro_torch.launch.roofline``): the
    H100 rates every bound here uses (HBM_BYTES_PER_S, INT_OPS_PER_S,
    H100_BF16_FLOPS, H100_F32_FLOPS) and ``io_bytes``, the bytes a
    pairing launch must move, which the planner uses too."""
    from repro_torch.launch import roofline
    return roofline


def _warp_spread(x):
    """Sum over the whole warps of 32 consecutive entries of x of
    (max x 32 / sum)."""
    w = x[:len(x) // 32 * 32].reshape(-1, 32).double()
    return float((w.max(1).values * 32 / w.sum(1)).sum())


def pairing_work(status, vstat, chunk=1 << 22):
    """{ops, ops_v1, pops_per_vertex, divergence, divergence_regrouped}
    of the pairing over these outputs.

    ``ops`` counts the integer operations the pairing needs on this run's
    data, whatever a kernel's design: per vertex 14 compares that find the
    lower ones among the 14 neighbours the star's rows reach, 36 + 2 x 24
    ANDs that decide which triangle and tet rows lie in the lower star, the
    sort of each lower-star row's key (1 compare for a triangle, 3 for a
    tet), and per pop one operation for each lower-star row still
    available (its test as a candidate, with its compare in the argmin):
    the lower edges for the vertex pop, then, counting every pair pop
    before every critical pop (the order with the fewest), the rows left.
    ``ops_v1`` counts the first port's loop the way its own model did: a
    setup of ~790, then per pop a 2-op scan of all 74 rows plus ~24 for
    every row still available.

    Pops per vertex are the vertex pop plus every pair and critical pop.
    ``divergence`` is the mean over warps of 32 consecutive vertices of
    (max pops x 32 / sum of pops): the loop trips a warp runs over the
    trips its threads need; ``divergence_regrouped`` is the same over the
    warps the kernels form (each block of 128 ordered by its number of
    lower neighbours, the count of lower edge rows).  Counted in vertex
    chunks (multiples of 128)."""
    import torch
    n = status.shape[0]
    ops = ops_v1 = 0
    pops_sum, div, divr, warps = 0, 0.0, 0.0, 0
    for i in range(0, n, chunk):
        st, vs = status[i:i + chunk], vstat[i:i + chunk]
        low = st != 0
        lower = low.sum(1)
        lower_edges = low[:, :14].sum(1)
        has_edge = (vs == 2).long()
        pairs = (st == 3).sum(1) - has_edge
        crits = (st == 4).sum(1)
        a0 = lower - has_edge
        iters = pairs + crits + 1
        avail_sum = (pairs * a0 - pairs * (pairs - 1)) \
            + (crits * (a0 - 2 * pairs) - crits * (crits - 1) // 2)
        ops_v1 += 790 * len(st) + int((148 * iters + 24 * avail_sum).sum())
        ops += (14 + 36 + 48) * len(st) + int(
            (low[:, 14:50].sum(1) + 3 * low[:, 50:].sum(1) + lower_edges
             + avail_sum).sum())
        pops = pairs + crits + 1
        pops_sum += int(pops.sum())
        div += _warp_spread(pops)
        m = len(pops) // 128 * 128
        order = torch.argsort(lower_edges[:m].reshape(-1, 128), dim=1,
                              stable=True)
        order = (order + torch.arange(0, m, 128, device=order.device)[:, None]
                 ).reshape(-1)
        divr += _warp_spread(pops[:m][order])
        warps += len(pops) // 32
    return dict(ops=ops, ops_v1=ops_v1, pops_per_vertex=pops_sum / n,
                divergence=div / max(warps, 1),
                divergence_regrouped=divr / max(n // 128 * 4, 1))


def bound_ms(work):
    """The least time for ``work``: its bytes over the memory rate or the
    operations it needs over the integer rate, whichever is longer."""
    RL = _roofline()
    t_b = work["bytes"] / RL.HBM_BYTES_PER_S * 1e3
    t_o = work["ops"] / RL.INT_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def ptxas_report(log_text):
    """{(halo, ranks): {registers, stack, spill_stores, spill_loads}} of
    each kernel instantiation in one source's ``ptxas -v`` log (``halo``:
    the fused kernel's halo entry, from the template's bool argument)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"I([a-z])(?:Lb([01])E)?E", m.group(1))
            cur = (t.group(2) == "1",
                   "int32" if t.group(1) == "i" else "int64")
            out[cur] = {}
        elif cur and "stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line))
            out[cur].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif cur and "Used" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) reg",
                                                  line).group(1))
    return out


def phase_build(smi):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import lower_star as LS
    t0 = time.perf_counter()
    info = build.build_all()
    secs = time.perf_counter() - t0
    log("build", seconds=round(secs, 3),
        per_source={k: round(v["seconds"], 3) for k, v in info.items()},
        card=repr(smi))
    report = {}
    for name, v in info.items():
        for (halo, ranks), r in ptxas_report(v["log"]).items():
            kname = name + "_halo" if halo else name
            dtype = torch.int32 if ranks == "int32" else torch.int64
            r.update(LS.kernel_attrs(kname, dtype))
            report[(kname, ranks)] = r
            log("ptxas", kernel=kname, ranks=ranks, **r)
    if len(report) != 6:
        raise AssertionError(f"expected 6 kernel instantiations, got "
                             f"{sorted(report)}")
    return report


def _rows_equal(got, want, what="the plain version"):
    """Max |got - want| over the four row outputs (0 when bit-equal)."""
    import torch
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max())
                  if a.numel() else 0)
        if not torch.equal(a, b):
            raise AssertionError(f"kernel rows differ from {what}")
    return err


def phase_kernels():
    import torch
    from repro_torch.core.gradient import neighbor_orders
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i32, i64, big = torch.int32, torch.int64, 3 << 31
    # (dims, batch, rank dtype, offset added to every rank)
    cases = [((5, 3, 7), 1, i32, 0), ((5, 3, 7), 1, i64, 0),
             ((33, 17, 9), 1, i32, 0), ((1, 5, 6), 1, i32, 0),
             ((7, 5, 1), 1, i64, 0), ((64, 1, 48), 1, i32, 0),
             ((16,), 1, i64, 0), ((40, 30, 20), 3, i32, 0),
             ((127, 127, 127), 1, i32, 0), ((128, 128, 128), 1, i32, 0),
             ((256, 256, 256), 1, i32, 0),
             # tile edges: no multiple of 128, nx = ny = 1, tiles that
             # cross a batch member's end, int64 ranks above 2^31
             ((129, 7, 5), 1, i32, 0), ((1, 1, 300), 1, i32, 0),
             ((1, 1, 300), 1, i64, big), ((7, 6, 5), 3, i32, 0),
             ((33, 17, 9), 1, i64, big), ((40, 30, 20), 3, i64, big),
             ((129, 1, 1), 3, i64, big),
             # the approximation levels of 256^3 below 128^3 and the
             # service's batch of four 64^3 fields
             ((64, 64, 64), 1, i32, 0), ((64, 64, 64), 4, i32, 0),
             ((32, 32, 32), 1, i32, 0), ((16, 16, 16), 1, i32, 0),
             ((8, 8, 8), 1, i32, 0), ((4, 4, 4), 1, i32, 0),
             ((2, 2, 2), 1, i32, 0)]
    max_err = 0
    for dims, B, dtype, offset in cases:
        g = Grid.of(*dims)
        f = torch.randn((B, g.nv), generator=gen, device="cuda")
        o = torch.stack([vertex_order(fb) for fb in f])
        nb = torch.cat([neighbor_orders(g, ob) for ob in o])
        want = ref.lower_star_gradient_torch(nb, o.reshape(-1),
                                             rank_bound=g.nv)
        o = (o + offset).to(dtype)
        nb = torch.cat([neighbor_orders(g, ob) for ob in o])
        # int64 ranks reach the kernels only when the bound forbids int32
        kb = g.nv + offset if dtype == torch.int32 else 2 ** 40
        fused = LS.fused_lower_star_gradient(g, o, rank_bound=kb)
        pre = LS.lower_star_gradient_prepass(nb, o.reshape(-1), rank_bound=kb)
        torch.cuda.synchronize()
        err = max(_rows_equal(fused, want), _rows_equal(pre, want))
        max_err = max(max_err, err)
        log("kernels", dims=dims, batch=B, ranks=str(dtype).split(".")[-1],
            offset=offset, packed_keys=ref.use_packed_keys(g.nv),
            max_abs_err=err)
        del f, o, nb, want, fused, pre
    torch.cuda.empty_cache()
    return max_err


def _chunk_ext(keys, c, dims):
    """The (nzl+2, ny, nx) halo key volume of chunk ``c`` of a field whose
    (value, vid) keys are ``keys``, as the streaming engine builds it."""
    from repro_torch.stream.scheduler import _ext_volume
    plane = dims[0] * dims[1]
    return _ext_volume(keys[c.glo * plane: c.ghi * plane], c, dims)


def phase_halo_kernels(isabel_256):
    """The fused kernel's halo entry on streamed chunks: bit-equal to the
    plain version on the same ext volume, and to the whole-grid fused rows
    of the same slab under ``vertex_order`` (order-isomorphic keys)."""
    import torch
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ops
    from repro_torch.stream import pack_value_keys_torch, plan_chunks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # (dims, chunk_z, field, chunks): "ends" takes the first, a middle
    # and the last chunk
    cases = [((256, 256, 256), 32, "isabel", "ends"),
             # the memmapped approximation level 1 of isabel 256^3
             ((128, 128, 128), 32, "isabel/2", "all"),
             ((64, 48, 40), 8, "normal", "all"),
             ((33, 17, 9), 9, "normal", "all"),    # one chunk, two -1 ghosts
             ((40, 30, 20), 1, "normal", "all"),   # nzl = 1
             ((1, 1, 300), 64, "normal", "all"),   # nx = ny = 1
             ((129, 7, 5), 2, "normal", "all"),    # ragged tiles
             ((64, 64, 32), 8, "ties", "all"),     # the vid decides
             ((48, 40, 24), 6, "positive", "all")]  # keys above 2^62
    max_err = 0
    for dims, cz, kind, which in cases:
        g = Grid.of(*dims)
        if kind == "isabel":
            f = torch.from_numpy(isabel_256).cuda()
        elif kind == "isabel/2":
            f = torch.from_numpy(isabel_256).cuda().reshape(
                (256,) * 3)[::2, ::2, ::2].reshape(-1)
        else:
            f = torch.randn(g.nv, generator=gen, device="cuda")
            if kind == "ties":
                f = torch.floor(f * 2)
            elif kind == "positive":
                f = f.abs() + 1
        keys = pack_value_keys_torch(f, 0)
        if kind == "positive" and int(keys.min()) <= 2 ** 62:
            raise AssertionError("positive values must give keys > 2^62")
        whole = LS.fused_lower_star_gradient(g, vertex_order(f))
        chunks = plan_chunks(g.dims, chunk_z=cz)
        if which == "ends":
            chunks = [chunks[0], chunks[len(chunks) // 2], chunks[-1]]
        plane = g.dims[0] * g.dims[1]
        for c in chunks:
            ext = _chunk_ext(keys, c, g.dims)
            got = LS.fused_rows_from_halo_volume(ext)
            plain = ops.lower_star_rows_halo(ext, backend="torch")
            sl = tuple(t[c.zlo * plane: c.zhi * plane] for t in whole)
            torch.cuda.synchronize()
            err = max(_rows_equal(got, plain), _rows_equal(got, sl))
            max_err = max(max_err, err)
            log("kernels", entry="halo", dims=dims, field=kind,
                chunk=(c.zlo, c.zhi), ghosts=("data" if c.glo < c.zlo
                                              else "-1",
                                              "data" if c.ghi > c.zhi
                                              else "-1"),
                keys=(int(ext[1:-1].min()), int(ext.max())),
                max_abs_err=err)
            del ext, got, plain, sl
        del f, keys, whole
    torch.cuda.empty_cache()
    return max(max_err, halo_ring(isabel_256))


def _ring_ext(o3, b, n_blocks):
    """The (nzl+2, ny, nx) ext volume of block ``b`` of a ring of
    ``n_blocks`` z-slabs of the order volume ``o3``: the neighbours'
    boundary planes as ghosts, -1 below the first block and above the
    last (what the distributed front-end's halo exchange builds)."""
    import torch
    nzl = o3.shape[0] // n_blocks
    z0, z1 = b * nzl, (b + 1) * nzl
    none = torch.full_like(o3[0], -1)
    return torch.cat([(o3[z0 - 1] if b > 0 else none)[None], o3[z0:z1],
                      (o3[z1] if b < n_blocks - 1 else none)[None]])


def halo_ring(isabel_256):
    """The halo entry's int32 instantiation (``ls_fused_halo_i32``) on the
    ext volumes of a block ring of dense ranks, as the distributed
    front-end feeds it: the first block (a -1 ghost below), a middle one
    (data on both sides) and the last (a -1 ghost above), bit-equal to the
    plain version on the same int32 volume and to the whole-grid fused
    rows of the same slab."""
    import torch
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    # (dims, blocks): isabel 256^3 in 8 blocks, then odd shapes
    cases = [((256, 256, 256), 8), ((64, 48, 40), 8), ((33, 17, 9), 3),
             ((40, 30, 20), 20), ((1, 1, 300), 4), ((129, 7, 6), 3)]
    max_err = 0
    for dims, nb in cases:
        g = Grid.of(*dims)
        f = torch.from_numpy(isabel_256).cuda() if dims[0] == 256 \
            else torch.randn(g.nv, generator=gen, device="cuda")
        o = vertex_order(f)
        whole = LS.fused_lower_star_gradient(g, o)
        o3 = o.reshape(g.dims[::-1])
        nvl = g.nv // nb
        for b in sorted({0, nb // 2, nb - 1}):
            ext = _ring_ext(o3, b, nb).to(torch.int32)
            got = LS.fused_rows_from_halo_volume(ext, rank_bound=g.nv)
            plain = ref.lower_star_gradient_torch(
                *LS.halo_owned_neighbors(ext), rank_bound=g.nv)
            sl = tuple(t[b * nvl:(b + 1) * nvl] for t in whole)
            torch.cuda.synchronize()
            err = max(_rows_equal(got, plain), _rows_equal(got, sl))
            max_err = max(max_err, err)
            log("kernels", entry="halo ring", dims=dims, blocks=nb, block=b,
                ranks=str(ext.dtype).split(".")[-1],
                ghosts=("data" if b > 0 else "-1",
                        "data" if b < nb - 1 else "-1"), max_abs_err=err)
            del ext, got, plain, sl
        del f, o, o3, whole
    torch.cuda.empty_cache()
    return max_err


def _check_result(res, grid):
    """Euler characteristic of the critical counts is 1, and every
    critical simplex is in the diagram once (a pair end or a class)."""
    crit = {k: int(res.stats[f"n_critical_d{k}"]) for k in range(grid.dim + 1)}
    chi = sum((-1) ** k * c for k, c in crit.items())
    if chi != 1:
        raise AssertionError(f"critical Euler characteristic {chi} != 1")
    arrs = res.arrays()
    for k in range(grid.dim + 1):
        n = len(arrs[f"d{k}.essential_sids"])
        n += len(arrs[f"d{k}.pairs_sids"]) if k < grid.dim else 0
        n += len(arrs[f"d{k - 1}.pairs_sids"]) if k else 0
        if n != crit[k]:
            raise AssertionError(f"dim {k}: {crit[k]} critical simplices, "
                                 f"{n} in the diagram")
    for k in range(grid.dim):
        pts = res.pairs(k, space="order")
        if len(pts) and not (pts[:, 1] >= pts[:, 0]).all():
            raise AssertionError(f"dim {k}: a pair dies before it is born")
    return crit


def _stage_line(res):
    return {k: round(v, 4) for k, v in res.stats.items()
            if isinstance(v, float)}


def phase_main(isabel_256):
    import numpy as np
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.pipeline import PersistencePipeline, TopoRequest

    runs = [("isabel", (256, 256, 256), "fused"),
            ("random", (128, 128, 128), "fused"),
            ("random", (128, 128, 128), "prepass")]
    fields = {(n, d): make_field(n, d, seed=SEED) for n, d, _ in runs
              if n != "isabel"}
    fields[("isabel", (256, 256, 256))] = isabel_256
    batch_dims = (64, 64, 64)
    batch = [make_field(n, batch_dims, seed=s)
             for n, s in (("random", 1), ("wavelet", 2), ("magnetic", 3))]
    torch.cuda.synchronize()

    for k in LS.LAUNCHES:
        LS.LAUNCHES[k] = 0
    ref.CUDA_CALLS["lower_star_gradient_torch"] = 0
    results = {}
    for name, dims, backend in runs:
        t0 = time.perf_counter()
        res = PersistencePipeline(backend).run(
            TopoRequest(field=fields[(name, dims)], grid=Grid.of(*dims)))
        results[(name, dims, backend)] = (res, time.perf_counter() - t0)
    t0 = time.perf_counter()
    batched = PersistencePipeline().run_batch(
        [TopoRequest(field=f, grid=Grid.of(*batch_dims)) for f in batch])
    batch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain_on_card = ref.CUDA_CALLS["lower_star_gradient_torch"]

    for (name, dims, backend), (res, secs) in results.items():
        crit = _check_result(res, Grid.of(*dims))
        log("main", field=name, dims=dims, backend=backend,
            seconds=round(secs, 3), critical=crit,
            pairs={p: len(res.pairs(p)) for p in range(len(dims))},
            betti=res.betti(), d1_rounds=res.stats.get("d1_rounds"),
            stages=_stage_line(res))
    a = results[("random", (128, 128, 128), "fused")][0]
    b = results[("random", (128, 128, 128), "prepass")][0]
    for p in a.homology_dims:
        if not np.array_equal(a.pairs(p, space="order"),
                              b.pairs(p, space="order")):
            raise AssertionError(f"prepass and fused diagrams differ in {p}")
    singles = [PersistencePipeline().run(
        TopoRequest(field=f, grid=Grid.of(*batch_dims))) for f in batch]
    for x, y in zip(batched, singles):
        _check_result(x, Grid.of(*batch_dims))
        for p in x.homology_dims:
            if not np.array_equal(x.pairs(p, space="order"),
                                  y.pairs(p, space="order")):
                raise AssertionError("run_batch differs from run")
    log("main", run_batch=len(batch), dims=batch_dims,
        seconds=round(batch_s, 3), launches=launches,
        plain_on_card=plain_on_card)
    if launches["fused"] < 1 or launches["prepass"] < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if plain_on_card:
        raise AssertionError("the plain version ran on the card path")
    return launches, fields, {k: r for k, (r, _) in results.items()}


def _zero_counts():
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    for k in LS.LAUNCHES:
        LS.LAUNCHES[k] = 0
    ref.CUDA_CALLS["lower_star_gradient_torch"] = 0


def _read_counts(n_chunks, what):
    """The launch counts of a streamed run: the halo entry once per chunk,
    no other kernel, the plain version never."""
    import torch
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    if launches != {"fused": 0, "prepass": 0, "fused_halo": n_chunks}:
        raise AssertionError(f"{what}: launches {launches}, want the halo "
                             f"entry once per chunk ({n_chunks})")
    if plain:
        raise AssertionError(f"{what}: the plain version ran on the card")
    return launches, plain


def _report_line(rep):
    keys = ("n_chunks", "chunk_z", "n_shards", "load_s", "compute_s",
            "scatter_s", "wall_s", "overlap_s", "comm_s", "comm_hidden_s",
            "overlap_fraction", "max_chunk_bytes",
            "peak_resident_field_bytes", "total_loaded_bytes", "key_bytes")
    return {k: getattr(rep, k) for k in keys}


def _same_gradient(a, b, what):
    import torch
    for name in ("pair_up", "pair_down", "crit"):
        da, db = getattr(a, name), getattr(b, name)
        if sorted(da) != sorted(db) or not all(
                torch.equal(da[k], db[k]) for k in da):
            raise AssertionError(f"{what}: {name} differs")


def _same_front(a, b, what):
    import torch
    _same_gradient(a.gf, b.gf, what)
    if not torch.equal(a.keys, b.keys):
        raise AssertionError(f"{what}: keys differ")


def phase_stream(fields, results):
    """The streamed path at full size: ``diagram_stream`` on ``isabel``
    256^3, the sharded engine, and an out-of-core 512^3 front-end; then
    the multi-card part (:func:`stream_cards`; a line says it did not run
    on one card).  Returns the halo entry's launches in the
    ``diagram_stream`` run and in the multi-card part."""
    import torch
    from repro_torch.core.gradient import euler_characteristic
    from repro_torch.core.grid import Grid
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import (ArraySource, FunctionSource,
                                    sharded_stream_front, stream_front)
    smi = nvidia_smi_line()
    g = Grid.of(256, 256, 256)
    isabel = fields[("isabel", g.dims)]
    src = ArraySource(isabel.reshape(256, 256, 256))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = PersistencePipeline().diagram_stream(src, chunk_z=32)
    secs = time.perf_counter() - t0
    launches, plain = _read_counts(res.stream.n_chunks, "diagram_stream")
    peak = torch.cuda.max_memory_allocated()
    rep = res.stream
    crit = _check_result(res, g)
    same = res.to_bytes() == results[("isabel", g.dims, "fused")].to_bytes()
    log("stream", path="diagram_stream", field="isabel", dims=g.dims,
        seconds=round(secs, 3), critical=crit, launches=launches,
        plain_on_card=plain, peak_device_bytes=peak,
        payload_equals_in_memory=same, stages=_stage_line(res),
        report=_report_line(rep), smi=smi)
    if rep.n_chunks != 8 or not same:
        raise AssertionError(f"streamed isabel 256^3: {rep.n_chunks} "
                             f"chunks, payload equal: {same}")
    if rep.peak_resident_field_bytes > 2 * rep.max_chunk_bytes:
        raise AssertionError("more than two chunks of field resident")
    halo_launches = launches["fused_halo"]
    del res

    dims = (128, 128, 128)
    rf = fields[("random", dims)]
    _zero_counts()
    t0 = time.perf_counter()
    res = PersistencePipeline().run(TopoRequest(
        field=ArraySource(rf.reshape(128, 128, 128)), stream=True,
        chunk_z=16, n_blocks=4, distributed=False))
    secs = time.perf_counter() - t0
    launches, plain = _read_counts(res.stream.n_chunks, "sharded run")
    same = res.to_bytes() == results[("random", dims, "fused")].to_bytes()
    log("stream", path="sharded x4 run", field="random", dims=dims,
        seconds=round(secs, 3), launches=launches, plain_on_card=plain,
        payload_equals_in_memory=same, stages=_stage_line(res),
        report=_report_line(res.stream), smi=smi)
    if res.stream.n_shards != 4 or not same:
        raise AssertionError("sharded random 128^3 differs from in-memory")
    del res

    torch.cuda.empty_cache()
    one = stream_front(src, chunk_z=32)
    _zero_counts()
    t0 = time.perf_counter()
    four = sharded_stream_front(src, 4, chunk_z=32)
    secs = time.perf_counter() - t0
    launches, _ = _read_counts(four.report.n_chunks, "sharded front-end")
    _same_front(four, one, "sharded isabel 256^3 front-end")
    log("stream", path="sharded_stream_front x4", field="isabel",
        dims=g.dims, seconds=round(secs, 3), equals_stream_front=True,
        launches=launches, report=_report_line(four.report),
        single_shard=_report_line(one.report), smi=smi)
    del one, four
    torch.cuda.empty_cache()

    dims = (512, 512, 512)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = stream_front(FunctionSource.synthetic("random", dims, seed=SEED),
                       chunk_budget=64 << 20)
    secs = time.perf_counter() - t0
    launches, _ = _read_counts(out.report.n_chunks, "out-of-core front-end")
    chi = euler_characteristic(out.gf)
    log("stream", path="stream_front out of core", field="random",
        dims=dims, seconds=round(secs, 3), critical=out.gf.n_critical(),
        euler=chi, launches=launches,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        report=_report_line(out.report), smi=smi)
    if chi != 1:
        raise AssertionError(f"512^3 critical Euler characteristic {chi}")
    del out
    torch.cuda.empty_cache()
    return halo_launches, stream_cards(smi)


# [stream]'s multi-card part: the out-of-core field, a MemmapSource of
# STREAM_BIG^3 `random` (512 MiB of f32) written once, through 4 shards
# with the default 64 MiB chunk budget, timed on 1, 2 and 4 cards
STREAM_BIG = 512
STREAM_SHARDS = 4
# the 4-shard runs held to one card's: (edge, chunk_z) of `random` end to
# end and of the `isabel` front-end, as [stream] runs them on one card
STREAM_RUN = (128, 16)
STREAM_FRONT = (256, 32)


def _visible(k):
    """CUDA_VISIBLE_DEVICES naming the first ``k`` of this process's
    cards."""
    have = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = have.split(",") if have else [str(i) for i in range(k)]
    return ",".join(ids[:k])


def _page_cache_share(path):
    """The share of ``path``'s pages in the page cache (``mincore`` over
    a read-only map of the file)."""
    import ctypes
    import mmap
    import numpy as np
    size = os.path.getsize(path)
    arr = np.memmap(path, dtype=np.uint8, mode="r")
    vec = (ctypes.c_ubyte * ((size + mmap.PAGESIZE - 1)
                             // mmap.PAGESIZE))()
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.mincore(ctypes.c_void_p(arr.ctypes.data),
                    ctypes.c_size_t(size), vec) != 0:
        raise OSError(ctypes.get_errno(), "mincore failed")
    del arr
    return float((np.frombuffer(vec, np.uint8) & 1).mean())


def _reset_cards(n):
    import torch
    for d in range(n):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def _card_peaks(n):
    import torch
    return {f"cuda:{d}": torch.cuda.max_memory_allocated(d)
            for d in range(n)}


def _check_shards(rep, cards, what):
    """Shard ``s`` on card ``s % N`` as ``per_shard`` names it, each with
    at most two ghost-extended chunks of field resident."""
    got = [st["device"] for st in rep.per_shard]
    want = [f"cuda:{s % cards}" for s in range(rep.n_shards)]
    if got != want:
        raise AssertionError(f"{what}: shards on {got}, want {want}")
    for st in rep.per_shard:
        if st["peak_resident_field_bytes"] > 2 * st["max_chunk_bytes"]:
            raise AssertionError(f"{what}: shard {st['shard']} held more "
                                 f"than two chunks of field")
    return got


def _largest_cube(overhead):
    """The largest n whose n^3 gradient and keys (``alloc_gradient``'s
    dtypes, sized on the meta device) and ``overhead`` fit card 0."""
    import torch
    from repro_torch.core import gradient as GR
    from repro_torch.core.grid import Grid
    total = torch.cuda.get_device_properties(0).total_memory

    def need(n):
        g = Grid.of(n, n, n)
        gf = GR.alloc_gradient(g, "meta")
        return sum(t.numel() * t.element_size()
                   for d in (gf.pair_up, gf.pair_down, gf.crit)
                   for t in d.values()) + 8 * g.nv + overhead
    lo, hi = 1, 4096
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if need(mid) <= total else (lo, mid - 1)
    return dict(n=lo, bytes=need(lo), card_bytes=total)


def stream_cards_child(path, out_path):
    """[stream]'s multi-card part in one process, on the cards that
    CUDA_VISIBLE_DEVICES leaves it (N of them).  Where N >= 2, the 4-shard
    runs that [stream] holds on one card: ``random`` 128^3 end to end
    (payload equal to the in-memory run) and ``isabel`` 256^3 front-end
    (gradient and keys equal to ``stream_front``'s); then the 512^3
    MemmapSource at ``path`` through 4 shards, timed.  Every run: shard
    ``s`` on card ``s % N`` (``per_shard``), at most two chunks resident
    a shard, each card's peak, the halo entry once per chunk.  Writes the
    launches, critical counts and seconds to ``out_path``."""
    import torch
    from repro_torch.core.gradient import euler_characteristic
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import build
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import (ArraySource, MemmapSource,
                                    sharded_stream_front, stream_front)
    from repro_torch.kernels import lower_star as LS
    build.build_all()
    cards = torch.cuda.device_count()
    smi = nvidia_smi_line()
    # the CUDA module loads per card: the attribute query on each
    for d in range(cards):
        with torch.cuda.device(d):
            log("stream", card=f"cuda:{d}", name=torch.cuda.get_device_name(d),
                fused_halo_i64=LS.kernel_attrs("fused_halo", torch.int64))
    halo = 0
    if cards >= 2:
        e, cz = STREAM_RUN
        dims = (e, e, e)
        rf = make_field("random", dims, seed=SEED)
        want = PersistencePipeline().run(
            TopoRequest(field=rf, grid=Grid.of(*dims))).to_bytes()
        _reset_cards(cards)
        _zero_counts()
        t0 = time.perf_counter()
        res = PersistencePipeline().run(TopoRequest(
            field=ArraySource(rf.reshape(e, e, e)), stream=True,
            chunk_z=cz, n_blocks=STREAM_SHARDS, distributed=False))
        secs = time.perf_counter() - t0
        launches, _ = _read_counts(res.stream.n_chunks,
                                   f"sharded run on {cards} cards")
        halo += launches["fused_halo"]
        on = _check_shards(res.stream, cards, f"sharded random {e}^3")
        same = res.to_bytes() == want
        log("stream", cards=cards, path="sharded x4 run", field="random",
            dims=dims, seconds=round(secs, 3), shard_devices=on,
            payload_equals_in_memory=same, card_peaks=_card_peaks(cards),
            launches=launches, report=_report_line(res.stream),
            link_bytes=[st["link_bytes"] for st in res.stream.per_shard],
            plan=res.plan.describe(), smi=smi)
        if not same:
            raise AssertionError(f"sharded random {e}^3 on {cards} cards "
                                 f"differs from in-memory")
        del res
        e, cz = STREAM_FRONT
        g = (e, e, e)
        src = ArraySource(make_field("isabel", g, seed=SEED)
                          .reshape(e, e, e))
        one = stream_front(src, chunk_z=cz)
        torch.cuda.synchronize()
        _reset_cards(cards)
        _zero_counts()
        t0 = time.perf_counter()
        four = sharded_stream_front(src, STREAM_SHARDS, chunk_z=cz)
        secs = time.perf_counter() - t0
        launches, _ = _read_counts(four.report.n_chunks,
                                   f"sharded front-end on {cards} cards")
        halo += launches["fused_halo"]
        on = _check_shards(four.report, cards, f"sharded isabel {e}^3")
        _same_front(four, one, f"sharded isabel {e}^3 on {cards} cards")
        log("stream", cards=cards, path="sharded_stream_front x4",
            field="isabel", dims=g, seconds=round(secs, 3),
            shard_devices=on, equals_stream_front=True,
            card_peaks=_card_peaks(cards), launches=launches,
            report=_report_line(four.report),
            link_bytes=[st["link_bytes"] for st in four.report.per_shard],
            smi=smi)
        del one, four, src
        torch.cuda.empty_cache()

    n = STREAM_BIG
    src = MemmapSource(path, (n, n, n))
    cached = _page_cache_share(path)
    _reset_cards(cards)
    _zero_counts()
    t0 = time.perf_counter()
    out = sharded_stream_front(src, STREAM_SHARDS, chunk_budget=64 << 20)
    secs = time.perf_counter() - t0
    launches, _ = _read_counts(out.report.n_chunks,
                               f"out-of-core front-end on {cards} cards")
    halo += launches["fused_halo"]
    on = _check_shards(out.report, cards, f"MemmapSource {n}^3")
    chi = euler_characteristic(out.gf)
    crit = out.gf.n_critical()
    peaks = _card_peaks(cards)
    home = sum(t.numel() * t.element_size()
               for d in (out.gf.pair_up, out.gf.pair_down, out.gf.crit)
               for t in d.values()) + out.keys.numel() * 8
    fits = _largest_cube(peaks["cuda:0"] - home)
    rep = out.report
    log("stream", cards=cards, path=f"sharded_stream_front x{STREAM_SHARDS} "
        "out of core", source="MemmapSource", field="random", dims=(n,) * 3,
        page_cache_share=cached, seconds=round(secs, 3), critical=crit,
        euler=chi, shard_devices=on, card_peaks=peaks,
        home_peak_bytes=peaks["cuda:0"], home_output_bytes=home,
        home_bytes_per_vertex=home / n ** 3, largest_cube_on_home=fits,
        launches=launches, report=_report_line(rep),
        per_shard=[{k: st[k] for k in (
            "shard", "device", "n_chunks", "load_s", "compute_s",
            "scatter_s", "comm_s", "comm_hidden_s", "wall_s", "link_bytes",
            "peak_device_bytes")} for st in rep.per_shard], smi=smi)
    if chi != 1:
        raise AssertionError(f"{n}^3 on {cards} cards: critical Euler "
                             f"characteristic {chi}")
    with open(out_path, "w") as fh:
        json.dump(dict(cards=cards, halo_launches=halo,
                       critical={str(k): v for k, v in crit.items()},
                       wall_s=rep.wall_s, seconds=secs), fh)
    return 0


def stream_cards(smi):
    """[stream]'s multi-card part: with two cards or more, one child
    process per card count (1, 2 and, with four cards, 4; the first cards
    each time), each running :func:`stream_cards_child` on the same
    MemmapSource file; their critical counts must agree.  With one card a
    line says it did not run.  Returns the halo launches."""
    import tempfile
    import torch
    from repro_torch.fields.generators import make_field
    from repro_torch.stream import MemmapSource
    cards = torch.cuda.device_count()
    if cards < 2:
        log("stream", cards=cards, multi_card="not run: one card, every "
            "shard on it (the checks above)")
        return 0
    counts = [1, 2] + ([4] if cards >= 4 else [])
    n = STREAM_BIG
    halo, recs = 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"random{n}.f32")
        t0 = time.perf_counter()
        MemmapSource.write(path, make_field("random", (n, n, n), seed=SEED)
                           .reshape(n, n, n))
        log("stream", memmap=path, bytes=os.path.getsize(path),
            write_s=round(time.perf_counter() - t0, 3),
            page_cache_share=_page_cache_share(path))
        for k in counts:
            out = os.path.join(tmp, f"cards{k}.json")
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--stream-cards-child", path, out], check=True,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=_visible(k)))
            with open(out) as fh:
                recs[k] = json.load(fh)
            recs[k]["process_s"] = time.perf_counter() - t0
            halo += recs[k]["halo_launches"]
    same = all(r["critical"] == recs[1]["critical"] for r in recs.values())
    log("stream", multi_card=counts, critical_equal=same,
        wall_s={k: r["wall_s"] for k, r in recs.items()},
        process_s={k: round(r["process_s"], 3) for k, r in recs.items()},
        halo_launches=halo, smi=smi)
    if not same:
        raise AssertionError(f"{n}^3 critical counts differ across card "
                             f"counts: {recs}")
    return halo


def _triplet_rows(saddles, t0, t1):
    """(n, 3) rows (saddle, min(t0, t1), max(t0, t1)) of the triplets
    whose ends differ, sorted lexicographically."""
    import torch
    saddles, t0, t1 = saddles.long(), t0.long(), t1.long()
    keep = t0 != t1
    rows = torch.stack([saddles[keep], torch.minimum(t0, t1)[keep],
                        torch.maximum(t0, t1)[keep]], 1)
    for c in (2, 1, 0):
        rows = rows[torch.argsort(rows[:, c], stable=True)]
    return rows


def _front_oracle(f, dims):
    """The in-memory (one block) front-end of the same field: vertex
    order, critical counts, and the D0 and dual triplet rows of
    ``build_d0_graph`` and ``build_dual_graph_chase`` on the fused
    kernel's gradient."""
    from repro_torch.core.extremum_graph import build_d0_graph
    from repro_torch.core.gradient import scatter_results_batch
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import ops
    from repro_torch.kernels.sandwich import (build_dual_graph_chase,
                                              extract_critical_kernel)
    g = Grid.of(*dims)
    o = vertex_order(f)
    [gf] = scatter_results_batch(g, *ops.lower_star_gradient(g, o))
    ci = extract_critical_kernel(g, gf, o)
    g0 = build_d0_graph(g, gf, ci)
    gD = build_dual_graph_chase(g, gf, ci, ci.crit_sids[2])
    ncrit = [int(gf.crit[k].sum()) for k in range(4)]
    return dict(order=o, ncrit=ncrit, g0=g0, gD=gD,
                d0=_triplet_rows(g0.saddles, g0.t0, g0.t1),
                dual=_triplet_rows(gD.saddles, gD.t0, gD.t1))


def _check_front(out, oracle, dims, rank_free, what):
    """run_front's outputs against the in-memory oracle: no overflow,
    everything resolved, ranks (or the key order), critical counts, and
    the D0 and dual triplet sets as sorted tensors."""
    import torch
    from repro_torch.distributed import front_triplets
    if bool(out["overflow"]) or int(out["unresolved"]):
        raise AssertionError(f"{what}: overflow {bool(out['overflow'])}, "
                             f"unresolved {int(out['unresolved'])}")
    ranks = out["ranks"]
    if rank_free:
        perm = torch.argsort(ranks)
        dense = torch.empty_like(perm)
        dense[perm] = torch.arange(len(perm), device=perm.device)
        ranks = dense
    if not torch.equal(ranks, oracle["order"]):
        raise AssertionError(f"{what}: ranks differ from vertex_order")
    if out["ncrit"].tolist() != oracle["ncrit"]:
        raise AssertionError(f"{what}: critical counts "
                             f"{out['ncrit'].tolist()} != {oracle['ncrit']}")
    (sid0, _, t0, t1), (sidd, _, s0, s1) = front_triplets(dims, out)
    if not torch.equal(_triplet_rows(sid0, t0, t1), oracle["d0"]):
        raise AssertionError(f"{what}: D0 triplets differ")
    if not torch.equal(_triplet_rows(sidd, s0, s1), oracle["dual"]):
        raise AssertionError(f"{what}: dual triplets differ")


def _run_front_logged(what, dims, f, n_blocks, **kw):
    """run_front with its per-step seconds, ring rotations, sample-sort
    bucket peak, buffer sizes and peak device memory logged."""
    import torch
    from repro_torch.distributed import run_front
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what lies on the card before the call (the whole field, [dist]'s
    # oracles and references) is outside the run's peak
    base = torch.cuda.memory_allocated()
    stats = {}
    t0 = time.perf_counter()
    cfg, out = run_front(dims, f, n_blocks, stats=stats, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    stats["baseline_device_bytes"] = base
    stats["run_peak_bytes"] = stats["peak_device_bytes"] - base
    log("dist", run_front=what, dims=dims, blocks=n_blocks,
        seconds=round(secs, 4),
        steps={k: round(v, 4) for k, v in stats["steps"].items()},
        ring_rotations=stats["ring_rotations"],
        sort_slack=stats.get("sort_slack"), sort_percap=stats.get(
            "sort_percap"), sort_bucket_peak=stats.get("sort_bucket_peak"),
        buffers=stats["buffers"], crit_capacity=cfg.crit_capacity,
        crit_peak=int(out["crit_peak"]),
        peak_device_bytes=stats["peak_device_bytes"],
        baseline_device_bytes=base, run_peak_bytes=stats["run_peak_bytes"],
        smi=nvidia_smi_line())
    return out, stats, secs


def phase_dist(isabel_256, n=256):
    """The distributed engines on the one card (``LocalRing``: all blocks
    on one device).  (a) ``run_front`` on ``isabel`` 256^3 in 8 blocks
    with the fused kernel's halo entry, sample-sorted (int32 ranks) and
    rank-free (int64 keys), against the in-memory front-end; ``prepass``
    with ``overlap_comm`` on and off at 128^3; (b) the ``shardmap``
    backend at 256^3, payload equal to ``fused``'s; (c)
    ``pairing_fixpoint`` on the 256^3 D0 and dual graphs, equal to
    ``pair_extrema_saddles_kernel``; (d) the whole ``distributed=True``
    path on ``random`` 32^3 and ``isabel`` 64^3 (the host token D1 bounds
    the size), payloads equal to the sequential runs'.  The launch
    counters are zeroed just before the distributed runs and read just
    after; returns them, the sample-sorted ``run_front``'s stats and
    seconds (for [plan]), and both ``run_front`` outputs with their slack
    and seconds (for [group])."""
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.distributed.pairing_rounds import pairing_fixpoint
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.kernels.sandwich import pair_extrema_saddles_kernel
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    dims = (n, n, n)
    nb = 8
    f = torch.from_numpy(isabel_256).cuda()
    oracle = _front_oracle(f, dims)
    h = n // 2
    f_h = torch.from_numpy(make_field("isabel", (h, h, h), seed=SEED)).cuda()
    oracle_h = _front_oracle(f_h, (h, h, h))
    req0 = TopoRequest(field=isabel_256, grid=Grid.of(*dims),
                       homology_dims=(0,))
    want0 = PersistencePipeline().run(req0)
    small = [(name, d, make_field(name, d, seed=SEED))
             for name, d in (("random", (32, 32, 32)),
                             ("isabel", (64, 64, 64)))]
    seq = {name: PersistencePipeline().run(TopoRequest(field=fs,
                                                       grid=Grid.of(*d)))
           for name, d, fs in small}
    torch.cuda.synchronize()

    _zero_counts()
    # (a) the front-end at full width: sample sort at the default slack,
    # doubled while a bucket overflows (logged), then rank-free keys
    slack = 2.0
    while True:
        out, stats, secs = _run_front_logged("fused, sample sort", dims,
                                             f, nb, sort_slack=slack)
        if not bool(out["overflow"]) or slack >= 64:
            break
        log("dist", overflow_at_slack=slack,
            bucket_peak=stats["sort_bucket_peak"], retry=2 * slack)
        slack *= 2
        _zero_counts()
    sort_out = out
    front = dict(stats, seconds=secs, dims=dims, blocks=nb)
    rf_out, _, rf_secs = _run_front_logged("fused, rank-free", dims, f, nb,
                                           use_sample_sort=False)
    pre = {}
    for ov in (True, False):
        pre[ov], _, _ = _run_front_logged(
            f"prepass, overlap_comm={ov}", (h, h, h), f_h, nb,
            gradient_backend="prepass", overlap_comm=ov, sort_slack=slack)
    # (b) the shardmap backend
    t0 = time.perf_counter()
    got0 = PersistencePipeline("shardmap", n_blocks=nb).run(req0)
    shard_s = time.perf_counter() - t0
    # (d) the whole distributed path
    dist = {}
    for name, d, fs in small:
        t0 = time.perf_counter()
        dist[name] = (PersistencePipeline(n_blocks=nb).run(
            TopoRequest(field=fs, grid=Grid.of(*d))),
            time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    want = {"fused": len(small), "prepass": 3 * nb + nb,
            "fused_halo": 3 * nb}
    log("dist", launches=launches, expected=want, plain_on_card=plain)
    if launches != want or plain:
        raise AssertionError(f"distributed launches {launches} (plain "
                             f"{plain}), want {want} and no plain version")

    _check_front(sort_out, oracle, dims, False, "run_front sample sort")
    _check_front(rf_out, oracle, dims, True, "run_front rank-free")
    for ov in (True, False):
        _check_front(pre[ov], oracle_h, (h, h, h), False,
                     f"prepass overlap_comm={ov}")
    for k in pre[True]:
        if not torch.equal(pre[True][k], pre[False][k]):
            raise AssertionError(f"overlap_comm on/off differ in {k}")
    log("dist", front="isabel", dims=dims, blocks=nb, equals_in_memory=True,
        rank_free_equals=True, prepass_overlap_equal=True)
    # [group] holds its GroupRing runs against these LocalRing outputs
    local = dict(sort=sort_out, rankfree=rf_out, slack=slack,
                 seconds=dict(sort=secs, rankfree=rf_secs))
    del sort_out, rf_out, pre, out

    # the halo entry's int32 instantiation at the distributed shape: one
    # middle block's ext volume (CUDA events), beside its bound
    plane = n * n
    ext = _ring_ext(oracle["order"].reshape(n, n, n), nb // 2, nb).to(
        torch.int32)
    rows = LS.fused_rows_from_halo_volume(ext, rank_bound=n ** 3)
    work = pairing_work(rows[0], rows[2])
    del rows
    work["bytes"] = _roofline().io_bytes(n // nb * plane, 4, False,
                                         ghosts=2 * plane)
    ms = cuda_ms(lambda: LS.fused_rows_from_halo_volume(
        ext, rank_bound=n ** 3), reps=5)
    bms, by = bound_ms(work)
    log("dist", timing="fused_halo int32", dims=tuple(ext.shape),
        block=nb // 2, ms=ms, bound_ms=bms, bound_by=by, bytes=work["bytes"],
        ops=work["ops"], pops_per_vertex=work["pops_per_vertex"], smi=smi)
    del ext

    same = got0.to_bytes() == want0.to_bytes()
    log("dist", backend="shardmap", dims=dims, blocks=nb, homology_dims=(0,),
        seconds=round(shard_s, 4), payload_equals_fused=same,
        stages=_stage_line(got0))
    if not same:
        raise AssertionError("shardmap payload differs from fused")

    # (c) the pairing rounds at full width
    for gname in ("g0", "gD"):
        graph = oracle[gname]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st = pairing_fixpoint(graph, collect_stats=True)
        torch.cuda.synchronize()
        fix_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        k = pair_extrema_saddles_kernel(graph)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t0
        same = all(torch.equal(getattr(p, a), getattr(k, a))
                   for a in ("saddles", "extrema", "unpaired"))
        log("dist", pairing_fixpoint=gname, dims=dims,
            triplets=len(graph.saddles), pairs=len(p.saddles),
            rounds=st.rounds, proposals=st.proposals,
            corrections=st.corrections, seconds=round(fix_s, 4),
            kernel_seconds=round(kern_s, 4), equals_kernel=same)
        if not same:
            raise AssertionError(f"pairing_fixpoint differs on {gname}")

    for name, d, _ in small:
        res, secs = dist[name]
        same = res.to_bytes() == seq[name].to_bytes()
        log("dist", distributed=name, dims=d, blocks=nb,
            seconds=round(secs, 4), payload_equals_sequential=same,
            sequential_seconds=round(seq[name].stats["d1"], 4),
            **{k: res.stats.get(k) for k in (
                "d0_rounds", "d0_corrections", "d_top_rounds", "d1_rounds",
                "d1_token_hops", "d1_expansions", "d1_merges",
                "d1_steals")}, stages=_stage_line(res))
        if not same:
            raise AssertionError(f"distributed {name} {d} differs from "
                                 f"the sequential payload")
    log("dist", seconds=round(time.perf_counter() - t_phase, 3), smi=smi)
    del oracle, oracle_h, f, f_h
    torch.cuda.empty_cache()
    return launches, front, local


GROUP_CARDS_MAX = 4


def _equal_outputs(got, want, what):
    """Every ``run_front`` array of ``got`` equal to ``want``'s, dtype
    and shape included."""
    import torch
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} != "
                             f"{sorted(want)}")
    for k, v in want.items():
        g = got[k]
        if g.dtype != v.dtype or not torch.equal(g, v):
            raise AssertionError(f"{what}: {k} differs from the LocalRing's")


def _group_front(dims, f, nb, slack, kind):
    """``run_front`` over the default ring (the process group's), timed
    to a synchronize: the sample sort at [dist]'s slack or rank-free."""
    import torch
    from repro_torch.distributed import run_front
    kw = dict(sort_slack=slack) if kind == "sort" \
        else dict(use_sample_sort=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_front(dims, f, nb, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _group_shardmap(req, nb):
    """(payload, seconds) of the ``distributed=True`` ``shardmap`` run of
    ``req`` in ``nb`` blocks."""
    from repro_torch.pipeline import PersistencePipeline
    t0 = time.perf_counter()
    res = PersistencePipeline("shardmap", n_blocks=nb,
                              distributed=True).run(req)
    return res.to_bytes(), time.perf_counter() - t0


def _digest(out):
    """{key: SHA-256 of dtype, shape and bytes} of ``run_front`` outputs."""
    import hashlib
    return {k: hashlib.sha256(f"{v.dtype}{tuple(v.shape)}".encode()
                              + v.cpu().numpy().tobytes()).hexdigest()
            for k, v in out.items()}


def _allreduce_check(rank, backend):
    """``allreduce_compressed`` over NCCL (CUDA tensors, the default
    group) against gloo's result (CPU tensors: a gloo subgroup, or the CPU
    side of a device-mapped group) on the same seeded gradients and
    residuals: the mean and the new residual equal bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import allreduce_compressed
    gen = torch.Generator().manual_seed(SEED + rank)
    g = {"b": torch.randn(4099, generator=gen),
         "w": torch.randn(512, 384, generator=gen)}
    r = {k: 1e-3 * torch.randn(v.shape, generator=gen) for k, v in g.items()}
    gloo = dist.new_group(backend="gloo") if backend == "nccl" else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, got_r = allreduce_compressed({k: v.cuda() for k, v in g.items()},
                                      {k: v.cuda() for k, v in r.items()})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want, want_r = allreduce_compressed(g, r, group=gloo)
    if gloo is not None:
        dist.destroy_process_group(gloo)
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in g)
    same = all(torch.equal(got[k].cpu(), want[k])
               and torch.equal(got_r[k].cpu(), want_r[k]) for k in g)
    return dict(equal=same, max_abs_err=err, seconds=secs,
                gloo="subgroup" if gloo is not None else "device-mapped")


def _group_rank(rank, world, init, root, field, dims, nb, slack, n_small,
                want_small, out_dir, backend="nccl", allreduce=False):
    """One rank of [group]'s multi-card case on card ``rank``, in a
    ``backend`` group (``nccl``, or the device-mapped ``cpu:gloo,
    cuda:nccl``): (a) ``run_front`` on ``field`` (``dims``) over the
    group, each output held on rank 0 against a LocalRing run on its card
    (the sample-sorted run twice, the repeat timed apart), and (c) the
    ``distributed=True`` payload at ``n_small``^3 equal to ``want_small``
    (the run without a group); with ``allreduce``, also
    :func:`_allreduce_check`.  Writes its seconds, launches, the digests
    of its (a) outputs and the all-reduce's result to
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core.grid import Grid
    from repro_torch.distributed import LocalRing, block_ring, run_front
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.pipeline import TopoRequest
    torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        f = torch.from_numpy(field).cuda()
        ring = block_ring(nb)
        if ring.bl != nb // world:
            raise AssertionError(f"rank {rank}: {ring.bl} blocks held")
        d_small = (n_small,) * 3
        req = TopoRequest(field=make_field("isabel", d_small, seed=SEED),
                          grid=Grid.of(*d_small))
        # the ranks start apart, and the first collective builds the
        # communicator: both stay out of the timed runs
        dist.barrier()
        _zero_counts()
        outs, secs = {}, {}
        for kind in ("sort", "rankfree"):
            outs[kind], secs[kind] = _group_front(dims, f, nb, slack, kind)
        # the first run also sets NCCL's point-to-point channels up: the
        # repeat shows what a run costs once they exist
        again, secs["sort_again"] = _group_front(dims, f, nb, slack, "sort")
        _equal_outputs(again, outs["sort"], f"{world} ranks, sort again")
        del again
        payload, secs["shardmap_distributed"] = _group_shardmap(req, nb)
        torch.cuda.synchronize()
        launches = dict(LS.LAUNCHES)
        dist.barrier()
        if payload != want_small:
            raise AssertionError(f"rank {rank}: the distributed=True "
                                 f"payload differs from the run without "
                                 f"a group")
        digests = {kind: _digest(out) for kind, out in outs.items()}
        if rank == 0:
            for kind, out in outs.items():
                kw = dict(sort_slack=slack) if kind == "sort" \
                    else dict(use_sample_sort=False)
                _, want = run_front(dims, f, nb, ring=LocalRing(nb), **kw)
                _equal_outputs(out, want, f"{world} ranks, {kind}")
                del want
        red = _allreduce_check(rank, backend) if allreduce else None
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(dict(seconds=secs, launches=launches,
                           device=str(ring.device), digests=digests,
                           allreduce=red), fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def group_ranks(isabel_256, dims, nb, slack, n_small, want_small, smi,
                world, backend="nccl", allreduce=False):
    """[group]'s multi-card case: one rank per card on ``world`` cards in
    a ``backend`` group, ``nb`` blocks.  Returns rank 0's digests."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_group_rank, nprocs=world, join=True, args=(
            world, "file://" + os.path.join(tmp, "rendezvous"), HERE,
            isabel_256, dims, nb, slack, n_small, want_small, tmp, backend,
            allreduce))
        wall = time.perf_counter() - t0
        recs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
    want = {"fused": 0, "prepass": 0, "fused_halo": 4 * (nb // world)}
    for r, rec in enumerate(recs):
        log("group", backend=backend, ranks=world, rank=r,
            device=rec["device"], blocks_per_rank=nb // world, seconds={
                k: round(v, 4) for k, v in rec["seconds"].items()},
            launches=rec["launches"], allreduce=rec["allreduce"], smi=smi)
        if rec["launches"] != want:
            raise AssertionError(f"rank {r}: launches {rec['launches']}, "
                                 f"want {want}")
        # rank 0's outputs equal its card's LocalRing run (checked there)
        if rec["digests"] != recs[0]["digests"]:
            raise AssertionError(f"rank {r}: run_front outputs differ from "
                                 f"rank 0's")
        if allreduce and not rec["allreduce"]["equal"]:
            raise AssertionError(f"{backend} rank {r}: allreduce_compressed "
                                 f"over NCCL differs from gloo's: "
                                 f"{rec['allreduce']}")
    log("group", backend=backend, ranks=world, blocks_per_rank=nb // world,
        run_front_equals_local=True, every_rank_equals_rank0=True,
        payload_equals_no_group=True,
        allreduce_equals_gloo=True if allreduce else None,
        spawn_seconds=round(wall, 3), smi=smi)
    return recs[0]["digests"]


def group_torchrun(smi, nproc=2, dims=(32, 32, 32)):
    """``examples/distributed_pd_torch.py`` under ``torchrun`` with one
    NCCL rank per card on ``nproc`` cards (``--stream`` too): it asserts
    DDMS == DMS and every rank's payload equal, and exits non-zero
    otherwise."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={nproc}",
         os.path.join(HERE, "examples", "distributed_pd_torch.py"),
         "--dims", *map(str, dims), "--stream"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=_visible(nproc)))
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    ok = proc.returncode == 0 and any(
        "DDMS == DMS: True; every rank's payload equal: True" in ln
        for ln in lines)
    log("group", torchrun="examples/distributed_pd_torch.py", ranks=nproc,
        dims=dims, returncode=proc.returncode, seconds=round(secs, 3),
        passed=ok, stdout=lines[-12:], smi=smi)
    if not ok:
        raise AssertionError(f"torchrun example failed (exit "
                             f"{proc.returncode}):\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")


def phase_group(isabel_256, local, n=256, n_small=64, nb=8):
    """[group]: the front-end over a ``torch.distributed`` process group
    on the card: a one-rank NCCL group holding all ``nb`` blocks (a
    ``GroupRing`` with Bl = nb, from ``block_ring``).  (a) ``run_front``
    on ``isabel`` n^3 with the halo entry, sample-sorted (int32 ranks, at
    [dist]'s slack) and rank-free (int64 keys), every output equal to
    [dist]'s LocalRing outputs ``local``; (b) the ``shardmap`` backend's
    rows at n^3 equal to the ``fused`` backend's; (c) the
    ``distributed=True`` ``shardmap`` payload at ``n_small``^3 equal to
    the same run without a group.  The comparisons' own runs come first;
    the launch counters are zeroed just before the group's runs and read
    just after.  Where the host has two cards or more, one NCCL rank per
    card (up to 4) repeats (a) and (c).  The group is destroyed before
    the phase returns the launches."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.distributed import GroupRing, block_ring
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.pipeline import TopoRequest
    from repro_torch.pipeline.backends import get_backend
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    slack = local["slack"]
    dims = (n, n, n)
    g = Grid.of(*dims)
    f = torch.from_numpy(isabel_256).cuda()
    order = vertex_order(f)[None]
    want_rows = get_backend("fused").rows(g, order)
    d_small = (n_small,) * 3
    req = TopoRequest(field=make_field("isabel", d_small, seed=SEED),
                      grid=Grid.of(*d_small))
    want_small, nogroup_s = _group_shardmap(req, nb)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=0, world_size=1)
        try:
            dist.barrier()            # builds the communicator, untimed
            ring = block_ring(nb)
            if not isinstance(ring, GroupRing) or ring.bl != nb:
                raise AssertionError(f"block_ring gave {ring!r} under the "
                                     f"group")
            _zero_counts()
            outs, secs = {}, {}
            for kind in ("sort", "rankfree"):
                outs[kind], secs[kind] = _group_front(dims, f, nb, slack,
                                                      kind)
            t0 = time.perf_counter()
            got_rows = get_backend("shardmap").rows_for(g, order,
                                                        n_blocks=nb)
            torch.cuda.synchronize()
            secs["shardmap_rows"] = time.perf_counter() - t0
            payload, secs["shardmap_distributed"] = _group_shardmap(req, nb)
            torch.cuda.synchronize()
            launches = dict(LS.LAUNCHES)
            plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
        finally:
            dist.destroy_process_group()
    want = {"fused": 0, "prepass": 0, "fused_halo": 4 * nb}
    log("group", launches=launches, expected=want, plain_on_card=plain)
    if launches != want or plain:
        raise AssertionError(f"[group] launches {launches} (plain {plain}),"
                             f" want {want} and no plain version")
    for kind in ("sort", "rankfree"):
        _equal_outputs(outs[kind], local[kind], f"one rank, {kind}")
        log("group", run_front=kind, dims=dims, blocks=nb, ranks=1,
            blocks_per_rank=nb, seconds=round(secs[kind], 4),
            dist_seconds=round(local["seconds"][kind], 4),
            equals_local_ring=True, smi=smi)
    del outs
    for name, a, b in zip(("status", "partner", "vstat", "vpart"),
                          got_rows, want_rows):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"shardmap rows over the group differ "
                                 f"from fused in {name}")
    log("group", backend="shardmap", dims=dims, blocks=nb,
        rows_equal_fused=True, seconds=round(secs["shardmap_rows"], 4),
        smi=smi)
    del got_rows, want_rows, order, f
    if payload != want_small:
        raise AssertionError("distributed=True shardmap payload over the "
                             "group differs from the run without one")
    log("group", distributed="isabel", dims=d_small, blocks=nb,
        seconds=round(secs["shardmap_distributed"], 4),
        no_group_seconds=round(nogroup_s, 4), payload_equals_no_group=True,
        smi=smi)
    local.clear()                 # [dist]'s outputs leave the card
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if cards >= 2:
        args = (isabel_256, dims, nb, slack, n_small, want_small, smi)
        digests = group_ranks(*args, world=2, allreduce=True)
        others = {}
        if cards >= GROUP_CARDS_MAX:
            others["nccl x4"] = group_ranks(*args, world=GROUP_CARDS_MAX)
        others["cpu:gloo,cuda:nccl x2"] = group_ranks(
            *args, world=2, backend="cpu:gloo,cuda:nccl", allreduce=True)
        for what, d in others.items():
            if d != digests:
                raise AssertionError(f"[group] {what}: run_front outputs "
                                     f"differ from 2 NCCL ranks'")
        log("group", cards=cards, equal_to_nccl_x2=sorted(others), smi=smi)
        group_torchrun(smi)
    else:
        log("group", cards=cards, multi_rank="not run: one NCCL rank per "
            "card needs two cards or more")
    log("group", seconds=round(time.perf_counter() - t_phase, 3), smi=smi)
    return launches


# budget of the dense bottleneck check: an (n x m) float64 distance matrix
# and a max-flow over up to n*m edges in Python (~2.5 s at 10^6 on a host
# core); a dimension whose n*m exceeds it is logged as skipped
GUARANTEE_BUDGET = 10 ** 6


def check_guarantee(res, exact, dims, what):
    """``bottleneck(res, exact) <= res.error_bound`` for each homology
    dimension whose pair counts fit GUARANTEE_BUDGET (essential classes
    always); returns ({dim: n x m checked}, {dim: n x m skipped})."""
    from repro_torch.approx import bottleneck_feasible, essential_distance
    bound = res.error_bound + 1e-9
    checked, skipped = {}, {}
    for p in range(len(dims)):
        a = res.pairs(p, min_persistence=0)
        b = exact.pairs(p, min_persistence=0)
        if essential_distance(res.essential(p), exact.essential(p)) > bound:
            raise AssertionError(f"{what}: essential classes of dim {p} "
                                 f"exceed the bound {bound}")
        nm = len(a) * len(b)
        if nm > GUARANTEE_BUDGET:
            skipped[p] = f"{len(a)}x{len(b)}"
            continue
        if not bottleneck_feasible(a, b, bound):
            raise AssertionError(f"{what}: dim {p} exceeds the bound {bound}")
        checked[p] = f"{len(a)}x{len(b)}"
    return checked, skipped


def time_block_minmax(f3, top, smi):
    """CUDA-event times of the level-1 ``block_minmax`` and of the cascade
    beside their byte bounds, and of ``max_pool3d`` (max and negated min)
    as the library call for the level-1 pass."""
    import torch
    import torch.nn.functional as F
    from repro_torch.approx import block_minmax
    from repro_torch.approx.hierarchy import cascade_minmax
    mn, mx = block_minmax(f3, 2)
    lib = lambda: (F.max_pool3d(f3[None, None], 2, 2, ceil_mode=True),
                   -F.max_pool3d(-f3[None, None], 2, 2, ceil_mode=True))
    lmx, lmn = lib()
    if not (torch.equal(lmx[0, 0], mx) and torch.equal(lmn[0, 0], mn)):
        raise AssertionError("max_pool3d disagrees with block_minmax")
    elt = f3.element_size()
    rec = {}
    for name, fn, nbytes in (
            ("block_minmax", lambda: block_minmax(f3, 2),
             f3.numel() * elt + 2 * mn.numel() * elt),
            ("cascade", lambda: cascade_minmax(mn, mx, top),
             sum(2 * mn.numel() * elt // 8 ** (l - 2)
                 + 2 * mn.numel() * elt // 8 ** (l - 1)
                 for l in range(2, top + 1)))):
        ms = cuda_ms(fn, reps=20)
        bms, by = bound_ms(dict(bytes=nbytes, ops=0))
        rec[name] = dict(ms=ms, bound_ms=bms, bound_by=by, bytes=nbytes)
    rec["block_minmax"]["library_ms"] = cuda_ms(lib, reps=20)
    for name, r in rec.items():
        log("approx", timing=name, dims=tuple(f3.shape), **r, smi=smi)


def phase_approx(fields, results, n=256):
    """Approximation on the card at ``isabel`` 256^3: the hierarchy
    (pyramid timed beside its bound; levels equal to the CPU's), every
    coarse level through ``approximate`` with its guarantee checked
    against the exact diagram of [main] as GUARANTEE_BUDGET allows, the
    full guarantee at 64^3 (``wavelet``), ``epsilon`` routing, ``refine`` with a
    deadline and to the end, and a ``MemmapSource`` at level 1 through
    the halo entry.  The launch counters are zeroed just before and read
    just after the approximation runs."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.approx import Hierarchy, approximate, refine
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import MemmapSource
    smi = nvidia_smi_line()
    g = Grid.of(n, n, n)
    isabel = fields[("isabel", g.dims)]
    exact = results[("isabel", g.dims, "fused")]
    pipe = PersistencePipeline()
    req = TopoRequest(field=isabel, grid=g)

    f3 = torch.from_numpy(isabel).to(pipe.device).reshape(n, n, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = Hierarchy(f3, g, device=pipe.device)
    build_s = time.perf_counter() - t0
    h_cpu = Hierarchy(isabel, g)
    cpu_levels = [(lv.level, lv.stride, lv.dims, lv.bound)
                  for lv in h_cpu.levels]
    levels = [(lv.level, lv.stride, lv.dims, lv.bound) for lv in h.levels]
    log("approx", hierarchy="isabel", dims=g.dims, seconds=round(build_s, 4),
        levels=levels, equals_cpu=levels == cpu_levels, smi=smi)
    if levels != cpu_levels or h.max_level != n.bit_length() - 2:
        raise AssertionError(f"hierarchy on the card {levels} differs "
                             f"from the CPU's {cpu_levels}")
    time_block_minmax(f3, h.max_level, smi)

    _zero_counts()
    by_level = {}
    for lv in h.levels[1:]:
        t0 = time.perf_counter()
        res = approximate(pipe, req, level=lv.level, hierarchy=h)
        secs = time.perf_counter() - t0
        checked, skipped = check_guarantee(res, exact, g.dims,
                                           f"level {lv.level}")
        log("approx", level=lv.level, dims=lv.dims, bound=lv.bound,
            seconds=round(secs, 4),
            pairs={p: len(res.pairs(p, min_persistence=0))
                   for p in range(3)},
            d1_rounds=res.stats.get("d1_rounds"), guarantee_checked=checked,
            guarantee_skipped=skipped, stages=_stage_line(res))
        if (res.error_bound, res.approx_level, res.grid_dims) != \
                (lv.bound, lv.level, lv.dims):
            raise AssertionError(f"level {lv.level}: wrong guarantee stamp")
        by_level[lv.level] = res
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    log("approx", levels_run=len(by_level), launches=launches,
        plain_on_card=plain)
    if launches["fused"] != len(by_level) or plain:
        raise AssertionError(f"approximation launches {launches}, plain "
                             f"{plain}: want the fused kernel once a level")

    # each level from 64^3 down, payload byte-equal to the same level on
    # the CPU (the plain version on the same decimated field)
    cpu_pipe = PersistencePipeline(device="cpu")
    for lv in h.levels[2:]:
        t0 = time.perf_counter()
        cpu = approximate(cpu_pipe, req, level=lv.level, hierarchy=h_cpu)
        same = cpu.to_bytes() == by_level[lv.level].to_bytes()
        log("approx", level=lv.level, dims=lv.dims, equals_cpu=same,
            cpu_seconds=round(time.perf_counter() - t0, 4))
        if not same:
            raise AssertionError(f"level {lv.level}: the card's payload "
                                 f"differs from the CPU's")

    # the whole guarantee at (n/4)^3, every level and every dimension, on the
    # smooth field whose pair counts fit the budget (isabel 64^3 has
    # 9980 / 25567 / 7121 pairs, too many for the dense check)
    q = n // 4
    f_q = make_field("wavelet", (q, q, q), seed=SEED)
    r_q = TopoRequest(field=f_q, grid=Grid.of(q, q, q))
    ex_q = pipe.run(r_q)
    for lv in Hierarchy(f_q, r_q.grid, device=pipe.device).levels[1:]:
        res = approximate(pipe, r_q, level=lv.level)
        checked, skipped = check_guarantee(res, ex_q, r_q.grid.dims,
                                           f"{q}^3 level {lv.level}")
        log("approx", full_check="wavelet", dims=r_q.grid.dims,
            level=lv.level, bound=lv.bound, guarantee_checked=checked,
            guarantee_skipped=skipped)
        if skipped:
            raise AssertionError(f"{q}^3 level {lv.level}: {skipped} did "
                                 f"not fit the budget")

    # epsilon picks the coarsest level that meets it
    eps = h.bound(3) + 1e-6
    want = h.pick_level(eps).level
    res = pipe.run(req.replace(epsilon=eps))
    log("approx", epsilon=eps, level=res.approx_level, expected=want)
    if res.approx_level != want or want != 3 or \
            res.to_bytes() != by_level[3].to_bytes():
        raise AssertionError(f"epsilon {eps} chose level "
                             f"{res.approx_level}, want {want}")

    # refine under a deadline: at least one result, bounds never grow
    t0 = time.perf_counter()
    walk = list(refine(pipe, req, deadline_s=0.5))
    bounds = [r.error_bound for r in walk]
    log("approx", refine="deadline_s=0.5", seconds=round(
        time.perf_counter() - t0, 4), levels=[r.approx_level for r in walk],
        bounds=bounds)
    if not walk or bounds != sorted(bounds, reverse=True):
        raise AssertionError(f"refine under a deadline gave {bounds}")

    # refine to the end at (n/2)^3 == run of the same progressive request
    f_h = make_field("isabel", (n // 2,) * 3, seed=SEED)
    r_h = TopoRequest(field=f_h, grid=Grid.of(n // 2, n // 2, n // 2))
    t0 = time.perf_counter()
    walk = list(refine(pipe, r_h))
    walk_s = time.perf_counter() - t0
    same = walk[-1].to_bytes() == pipe.run(
        r_h.replace(progressive=True)).to_bytes()
    log("approx", refine="to the end", field="isabel", dims=r_h.grid.dims,
        seconds=round(walk_s, 4), levels=[r.approx_level for r in walk],
        bounds=[r.error_bound for r in walk], equals_run=same)
    if not same or walk[-1].error_bound != 0.0:
        raise AssertionError("refine's last result differs from run")

    # out of core: a MemmapSource of the n^3 field at level 1
    with tempfile.TemporaryDirectory() as tmp:
        src = MemmapSource.write(os.path.join(tmp, "isabel.raw"),
                                 isabel.reshape(n, n, n))
        _zero_counts()
        t0 = time.perf_counter()
        res = approximate(pipe, TopoRequest(field=src, chunk_z=n // 4),
                          level=1)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(LS.LAUNCHES)
        plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    same = res.to_bytes() == by_level[1].to_bytes()
    log("approx", source="memmap", level=1, seconds=round(secs, 4),
        launches=launches, plain_on_card=plain, equals_in_memory=same,
        report=_report_line(res.stream), stages=_stage_line(res))
    if not same or launches["fused_halo"] != res.stream.n_chunks or plain:
        raise AssertionError("streamed level 1 differs or skipped the "
                             "halo entry")
    del f3, h, by_level
    torch.cuda.empty_cache()


def phase_serve(fields, n=256):
    """``TopoService`` on the card: four same-shape 64^3 fields from
    client threads in one batched dispatch (equal to ``run``), resubmitted
    as cache hits with no kernel launch, a progressive 256^3 submit with a
    deadline (preview first), a later ``epsilon`` submit served from the
    entry refinement stored, a ``wire=True`` payload, a traced request
    with one span per stage, and ``stats_payload``."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.obs import validate_trace_events
    from repro_torch.pipeline import (DiagramResult, PersistencePipeline,
                                      TopoRequest)
    from repro_torch.serve import TopoService, stats_payload
    smi = nvidia_smi_line()
    dims = (n // 4,) * 3
    vols = [make_field(name, dims, seed=s).reshape(dims)
            for name, s in (("random", 1), ("wavelet", 2), ("magnetic", 3),
                            ("isabel", 4))]
    pipe = PersistencePipeline()
    want = [pipe.run(TopoRequest(field=v)).to_bytes() for v in vols]
    isabel = fields[("isabel", (n, n, n))].reshape(n, n, n)
    with TopoService(pipe, cache=True, max_batch=8, max_wait_s=0.5) as svc:
        futs = [None] * 4
        gate = threading.Barrier(4)

        def client(i):
            gate.wait()
            futs[i] = svc.submit(vols[i])

        _zero_counts()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        got = [f.result(timeout=300) for f in futs]
        batch_s = time.perf_counter() - t0
        launches = dict(LS.LAUNCHES)
        same = [r.to_bytes() == w for r, w in zip(got, want)]
        log("serve", batch=4, dims=dims, seconds=round(batch_s, 4),
            batches=svc.stats.batches, max_batch=svc.stats.max_batch,
            launches=launches, equals_run=same, smi=smi)
        if svc.stats.batches != 1 or launches["fused"] != 1 or not all(same):
            raise AssertionError("four same-shape submits were not served "
                                 "in one batched dispatch equal to run")

        _zero_counts()
        t0 = time.perf_counter()
        futs = [svc.submit(v) for v in vols]
        hits = [f.result(timeout=300) for f in futs]
        hit_s = time.perf_counter() - t0
        launches = dict(LS.LAUNCHES)
        same = [r.to_bytes() == w for r, w in zip(hits, want)]
        log("serve", resubmit=4, seconds=round(hit_s, 4),
            cache_hits=svc.stats.cache_hits, launches=launches,
            equals_run=same)
        if svc.stats.cache_hits != 4 or sum(launches.values()) or \
                not all(same):
            raise AssertionError("resubmits were not pure cache hits")

        _zero_counts()
        seen = {}
        t0 = time.perf_counter()
        fut = svc.submit(TopoRequest(field=isabel, deadline_s=1.0))
        # stamped where each future resolves (or at once if already done);
        # the preview's stamp records whether the final had resolved
        fut.preview.add_done_callback(lambda _: seen.setdefault(
            "preview", (time.perf_counter() - t0, fut.done())))
        fut.add_done_callback(lambda _: seen.setdefault(
            "final", (time.perf_counter() - t0, True)))
        preview = fut.preview.result(timeout=600)
        final = fut.result(timeout=600)
        (preview_s, final_first), (final_s, _) = seen["preview"], \
            seen["final"]
        top = n.bit_length() - 2
        levels = [r.approx_level for r in fut.partials]
        bounds = [r.error_bound for r in fut.partials]
        log("serve", progressive="isabel", dims=(n,) * 3, deadline_s=1.0,
            preview_s=round(preview_s, 4), final_s=round(final_s, 4),
            final_done_at_preview=final_first, levels=levels, bounds=bounds,
            launches=dict(LS.LAUNCHES),
            plain_on_card=ref.CUDA_CALLS["lower_star_gradient_torch"])
        if final_first or preview.approx_level != top \
                or fut.partials[0] is not preview \
                or fut.partials[-1] is not final \
                or (final.approx_level < top and len(levels) < 2) \
                or bounds != sorted(bounds, reverse=True) \
                or ref.CUDA_CALLS["lower_star_gradient_torch"]:
            raise AssertionError("progressive submit out of order")

        hits0 = svc.stats.cache_hits
        later = svc.submit(TopoRequest(field=isabel,
                                       epsilon=final.error_bound)) \
            .result(timeout=600)
        log("serve", epsilon=final.error_bound,
            served_from_cache=svc.stats.cache_hits == hits0 + 1,
            level=later.approx_level)
        if svc.stats.cache_hits != hits0 + 1 or \
                later.to_bytes() != final.to_bytes():
            raise AssertionError("the epsilon submit was not served from "
                                 "the refined entry")

        traced = svc.submit(TopoRequest(field=vols[0], trace=True)) \
            .result(timeout=300)
        doc = traced.trace.to_dict()
        validate_trace_events(doc)
        spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        # one span per stage; D0 / D1 round spans nest inside them
        rounds = {n: spans.count(n) for n in ("d0_round", "d1_round")}
        stages = [n for n in spans if n not in rounds]
        log("serve", traced=True, spans=stages, round_spans=rounds,
            d1_rounds=traced.stats.get("d1_rounds"),
            equals_run=traced.to_bytes() == want[0])
        if stages != list(traced.plan.stage_names) or \
                traced.to_bytes() != want[0] or not rounds["d0_round"]:
            raise AssertionError(f"traced run spans {spans}")
        stats = json.loads(stats_payload(svc))
        log("serve", stats=json.dumps(stats, sort_keys=True))
    with TopoService(pipe, wire=True) as svc:
        blob = svc.submit(vols[1]).result(timeout=300)
    back = DiagramResult.from_bytes(blob)
    log("serve", wire=True, bytes=len(blob), decodes=back.betti())
    if blob != want[1]:
        raise AssertionError("wire payload differs from run's")


def phase_gradient(isabel_256):
    """The full discrete-vector-field check (``check_gradient_valid``:
    every valid simplex in exactly one role, pairs incident and inside one
    lower star, Euler characteristic 1) on the fused kernel's gradient of
    the main path's 256^3 field."""
    import torch
    from repro_torch.core.gradient import (check_gradient_valid,
                                           euler_characteristic,
                                           scatter_results_batch)
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import ops
    g = Grid.of(256, 256, 256)
    o = vertex_order(torch.from_numpy(isabel_256).cuda())
    [gf] = scatter_results_batch(g, *ops.lower_star_gradient(g, o))
    check_gradient_valid(g, gf, o)
    log("gradient", field="isabel", dims=g.dims, valid=True,
        euler=euler_characteristic(gf), critical=gf.n_critical())
    del gf, o
    torch.cuda.empty_cache()


def phase_cpu():
    import numpy as np
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    for name, dims in (("wavelet", (32, 32, 32)), ("random", (32, 32, 32)),
                       ("random", (96, 2, 80))):
        f = make_field(name, dims, seed=SEED)
        req = TopoRequest(field=f, grid=Grid.of(*dims))
        gpu = PersistencePipeline().run(req)
        cpu = PersistencePipeline(device="cpu").run(req)
        for key, arr in cpu.arrays().items():
            if not np.array_equal(arr, gpu.arrays()[key], equal_nan=True):
                raise AssertionError(f"{name} {dims}: {key} differs")
        log("cpu", field=name, dims=dims, equal=True,
            pairs={p: len(cpu.pairs(p)) for p in cpu.homology_dims})


# tests/test_dms.py's oracle cases: (dims, seed) of a standard normal field
ORACLE_CASES = ([((12,), s) for s in range(4)]
                + [((5, 5), 0), ((6, 4), 1), ((4, 7), 2), ((8, 3), 3),
                   ((5, 5), 4)]
                + [((4, 4, 4), 0), ((3, 4, 5), 1), ((5, 3, 3), 2),
                   ((4, 4, 3), 3), ((3, 3, 3), 4), ((4, 5, 3), 5)])


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, round(time.perf_counter() - t0, 3)


def _oracle_rows(n):
    """Fused and prepass rows on the card byte-equal to literal Robins on
    the host (and the scattered gradients equal)."""
    import torch
    from repro_torch.core.gradient import (lower_star_rows_np,
                                           scatter_results_batch)
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import ops
    cases = [("random", (n,) * 3, False), ("wavelet", (n,) * 3, False),
             ("isabel", (n,) * 3, False), ("isabel", (n,) * 3, True),
             ("random", (13, 7, 5), False), ("magnetic", (5, 11, 9), False)]
    for name, dims, masked in cases:
        g = Grid.of(*dims)
        o = vertex_order(torch.from_numpy(make_field(name, dims,
                                                     seed=SEED)).cuda())
        t0 = time.perf_counter()
        want = tuple(torch.from_numpy(r).cuda() for r in
                     lower_star_rows_np(g, o.cpu().numpy(), masked=masked))
        np_s = round(time.perf_counter() - t0, 3)
        [gf_np] = scatter_results_batch(g, *want)
        secs = {}
        for backend in ("fused", "prepass"):
            rows, secs[backend] = _timed(
                lambda: ops.lower_star_gradient(g, o, backend))
            _rows_equal(rows, want, f"literal Robins ({name} {dims})")
            [gf] = scatter_results_batch(g, *rows)
            _same_gradient(gf, gf_np, f"{backend} {name} {dims}")
        log("oracle", check="rows", field=name, dims=dims,
            compared="fused+prepass rows and gradients vs literal Robins "
            + ("(masked form)" if masked else "(heapq)"), equal=True,
            np_s=np_s, fused_s=secs["fused"], prepass_s=secs["prepass"])


def _oracle_diagrams(n_big, n_np):
    """Diagrams of the fused, prepass and streamed (halo entry) routes, and
    of the np gradient with the np sandwich, against the boundary-matrix
    reduction."""
    import numpy as np
    import torch
    from repro_torch.core.diagram import diff_report, same_offdiagonal
    from repro_torch.core.dms import oracle_to_diagram
    from repro_torch.core.grid import Grid
    from repro_torch.core.reduction import compute_oracle
    from repro_torch.fields.generators import make_field
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import ArraySource

    def normal(dims, seed):
        # float32, as stream sources take it
        return np.random.default_rng(seed).standard_normal(
            Grid.of(*dims).nv).astype(np.float32)
    all_routes = ("fused", "prepass", "stream", "np/np")
    cases = [(f"normal seed {s}", dims, normal(dims, s), all_routes)
             for dims, s in ORACLE_CASES]
    cases.append(("random", (n_big,) * 3,
                  make_field("random", (n_big,) * 3, seed=SEED),
                  ("fused", "prepass", "stream")))
    cases.append(("isabel", (n_np,) * 3,
                  make_field("isabel", (n_np,) * 3, seed=SEED), all_routes))
    for name, dims, f, routes in cases:
        g = Grid.of(*dims)
        nx, ny, nz = g.dims
        orc, orc_s = _timed(lambda: oracle_to_diagram(compute_oracle(g, f),
                                                      g))
        for route in routes:
            req = TopoRequest(field=f, grid=g)
            chunks = 1
            if route == "stream":
                req = TopoRequest(field=ArraySource(f.reshape(nz, ny, nx)),
                                  stream=True, chunk_z=max(1, nz // 4))
                pipe = PersistencePipeline()
            elif route == "np/np":
                pipe = PersistencePipeline("np", sandwich_backend="np")
            else:
                pipe = PersistencePipeline(route)
            res, secs = _timed(lambda: pipe.run(req))
            if route == "stream":
                chunks = res.stream.n_chunks
                if nz > 1 and chunks < 2:
                    raise AssertionError(f"{name} {dims}: one chunk")
            dg = res.diagram
            same = same_offdiagonal(dg, orc) and all(
                torch.equal(dg.essential_orders(p).cpu(),
                            orc.essential_orders(p))
                for p in range(g.dim + 1))
            if not same:
                raise AssertionError(f"{name} {dims} {route}: "
                                     + diff_report(dg, orc, (route,
                                                             "oracle")))
            log("oracle", check="diagram", field=name, dims=dims,
                compared=f"{route} vs compute_oracle", chunks=chunks,
                equal=True, betti=dg.betti(), oracle_s=orc_s,
                route_s=secs)


def _oracle_mixed(n):
    """The fused gradient with the np sandwich: payload equal to the torch
    sandwich's, critical counts consistent with the diagram."""
    import numpy as np
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    g = Grid.of(n, n, n)
    for name in ("random", "isabel"):
        req = TopoRequest(field=make_field(name, g.dims, seed=SEED), grid=g)
        mixed, mixed_s = _timed(lambda: PersistencePipeline(
            "fused", sandwich_backend="np").run(req))
        plain, plain_s = _timed(lambda: PersistencePipeline().run(req))
        want = plain.arrays()
        for key, arr in mixed.arrays().items():
            if not np.array_equal(arr, want[key], equal_nan=True):
                raise AssertionError(f"fused/np {name}: {key} differs from "
                                     f"fused/torch")
        crit = _check_result(mixed, g)
        log("oracle", check="mixed", field=name, dims=g.dims,
            compared="fused/np arrays vs fused/torch", equal=True,
            critical=crit, np_sandwich_s=mixed_s, torch_sandwich_s=plain_s,
            d1_expansions=mixed.stats["d1_expansions"])


def _oracle_surface(n):
    """compile (a second call hits the plan cache), diagram / diagrams
    equal to run, StageReport.to_dict through JSON."""
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.pipeline import (PersistencePipeline, PlanCache,
                                      TopoRequest)
    g = Grid.of(n, n, n)
    f = make_field("wavelet", g.dims, seed=SEED)
    pipe = PersistencePipeline(plan_cache=PlanCache())
    first = pipe.compile(TopoRequest(field=f, grid=g))
    hits = pipe.plan_cache.hits
    again = pipe.compile(TopoRequest(field=f, grid=g))
    if pipe.plan_cache.hits != hits + 1 or \
            again.row_offsets is not first.row_offsets:
        raise AssertionError(f"second compile missed the plan cache: "
                             f"{pipe.plan_cache.stats()}")
    (res, one, two), secs = _timed(lambda: (
        pipe.run(TopoRequest(field=f, grid=g, include_report=True)),
        pipe.diagram(f, grid=g), pipe.diagrams([f, f], grid=g)))
    want = res.to_bytes()
    if not all(r.to_bytes() == want for r in (one, *two)):
        raise AssertionError("diagram / diagrams differ from run")
    doc = res.report.to_dict()
    if json.loads(json.dumps(doc)) != doc:
        raise AssertionError("StageReport.to_dict does not round-trip")
    log("oracle", check="surface", field="wavelet", dims=g.dims,
        compared="compile twice (cache hit), diagram, diagrams([f, f]) vs "
        "run, to_dict via JSON", equal=True, seconds=secs,
        plan_cache=pipe.plan_cache.stats(),
        front_s=round(doc["front_seconds"], 4),
        back_s=round(doc["back_seconds"], 4))


def phase_oracle(n_rows=16, n_big=32, n_np=16, n_mixed=32):
    """The kernels' rows and the pipeline's diagrams against the numpy
    oracles (literal Robins, the boundary-matrix reduction), the mixed
    fused / np route and the pipeline surface.  Launch counters zeroed just
    before and read just after; returns the launches."""
    import torch
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    _zero_counts()
    _oracle_rows(n_rows)
    _oracle_diagrams(n_big, n_np)
    _oracle_mixed(n_mixed)
    _oracle_surface(n_np)
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    log("oracle", seconds=round(time.perf_counter() - t_phase, 3),
        launches=launches, plain_on_card=plain, smi=smi)
    if plain or min(launches.values()) < 1:
        raise AssertionError(f"[oracle] launches {launches}, plain {plain}")
    return launches


# --------------------------------------------------------------------------
# [lm]: the LM substrate's serving path (models/, configs/, serve.generate)
# --------------------------------------------------------------------------

# card against CPU at smoke size: logits within LM_ATOL (8 bf16 ulps at the
# smoke logits' |x| < 1; cuBLAS and the CPU accumulate the same bf16
# products in another order), cache leaves within LM_LEAF_TOL of the
# leaf's largest magnitude (8 ulps of its largest entry), dtypes equal;
# greedy tokens equal up to the first step where they differ, which must
# be a near tie (the CPU's top-1/top-2 margin <= 2 * LM_ATOL)
LM_ATOL = 0.03
LM_LEAF_TOL = 2.0 ** -5
# the full-width models (name, layers kept or None for all), one per mixer
# family; moonshot's 48 layers hold 112 GB of f32 parameters, so 4.
# minicpm3-4b runs 16 of its 62 layers: at 62 its prefills (11.8 s each,
# naive, absorbed, f32 and the controls) were the longest part of [lm],
# and [train] needs that time within the script's limit
LM_FULL = (("minitron-4b", None), ("mamba2-2.7b", None),
           ("minicpm3-4b", 16), ("moonshot-v1-16b-a3b", 4))
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 64, 32
LM_PROFILE_STEPS = 4
# prefill by decode steps (what generate does) against lm_apply(prompts)
# [:, -1], as the RMS of the difference over the RMS of the second, on the
# real vocabulary.  In f32 compute (COMPUTE_DTYPE float32 for the check)
# the two differ only by f32 rounding: LM_F32_TOL.  In the reference's
# dtypes (bf16 compute) 32-64 random layers amplify the rounding of GEMMs
# that sum in another order (0.043-0.060 on the card), so the served
# path is held to the f32 forward instead: the bf16 prefill's distance
# to it at most LM_BF16_RATIO times the bf16 forward's own.  Sound paths
# read 0.92-1.04 on the card (the absorbed MLA, which reassociates the
# bf16 products, the highest); the controls below read 2.45-5.96, so the
# gate lies between.  Absorbed against naive MLA: within LM_F32_TOL in
# f32 compute, the same ratio in bf16.
LM_F32_TOL = 1e-3
LM_BF16_RATIO = 1.5
# known faults of the decode path (_lm_fault), read on every run: each
# must fail the bf16 gate or the cache dtype check (_lm_cache_dtype_faults)
# -- the SSM state kept bf16 moves the logits less than bf16 rounding
# does (0.96x on the card), so only its dtype shows it
LM_CONTROLS = ("cache_fp8", "act_fp8", "state_bf16")


def _lm_leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_lm_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _lm_caches_close(a, b, what):
    """Max |a - b| over the leaves of two caches (same keys, shapes and
    dtypes; integer leaves equal; floats within LM_LEAF_TOL)."""
    import torch
    la, lb = _lm_leaves(a), _lm_leaves(b)
    if sorted(la) != sorted(lb):
        raise AssertionError(f"[lm] {what}: cache keys {sorted(la)}")
    err = 0.0
    for k, x in la.items():
        y = lb[k].to(x.device)
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"[lm] {what} {k}: {x.dtype}{tuple(x.shape)}"
                                 f" vs {y.dtype}{tuple(y.shape)}")
        if not x.is_floating_point():
            if not torch.equal(x, y):
                raise AssertionError(f"[lm] {what} {k} differs")
            continue
        d = float((x.float() - y.float()).abs().max())
        if d > LM_LEAF_TOL * max(float(y.float().abs().max()), 1e-30):
            raise AssertionError(f"[lm] {what} {k}: max |diff| {d}")
        err = max(err, d)
    return err


def _lm_logits_close(a, b, what, atol=LM_ATOL):
    d = float((a.float().cpu() - b.float().cpu()).abs().max())
    if not d <= atol:
        raise AssertionError(f"[lm] {what}: max |diff| {d} > {atol}")
    return d


def _lm_smoke_inputs(cfg, rng):
    import numpy as np
    import torch
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    frontend = None
    if cfg.enc_dec:
        frontend = rng.standard_normal((2, cfg.enc_len, cfg.d_model))
    elif cfg.frontend == "vision_stub":
        frontend = rng.standard_normal((2, cfg.n_patches, cfg.d_model))
    if frontend is not None:
        frontend = torch.from_numpy(frontend).to(torch.bfloat16)
    return tokens, prompts, frontend


def lm_smoke(arch, dev):
    """One smoke architecture on ``dev`` against the CPU: one seeded
    parameter tree given to both, ``lm_apply``, two ``decode_step``s and
    a greedy ``generate`` of 8 tokens."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax, params_to_numpy
    from repro_torch.serve import generate
    cfg = smoke_config(arch)
    cpu = T.init_params(cfg, SEED, device="cpu")
    card = params_from_jax(cfg, params_to_numpy(cpu), device=dev)
    tokens, prompts, frontend = _lm_smoke_inputs(
        cfg, np.random.default_rng(zlib.crc32(arch.encode())))
    out = {}
    with torch.no_grad():
        runs = {}
        for name, p, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
            fe = None if frontend is None else frontend.to(d)
            logits, aux = T.lm_apply(cfg, p, torch.from_numpy(tokens).to(d),
                                     fe)
            cache = T.init_cache(cfg, 2, 12, device=d)
            if cfg.enc_dec:
                cache = dict(cache, enc_out=T._encoder_apply(cfg, p, fe)
                             .to(torch.bfloat16))
            steps = []
            for t in (prompts[:, 0], prompts[:, 1]):
                lg, cache = T.decode_step(cfg, p, cache,
                                          torch.from_numpy(t).to(d))
                steps.append((lg, cache))
            runs[name] = (logits, aux, steps)
        (lc, ac, sc), (lg, ag, sg) = runs["cpu"], runs["card"]
        out["lm_apply"] = _lm_logits_close(lg, lc, f"{arch} lm_apply")
        if abs(float(ag) - float(ac)) > 1e-3 * max(abs(float(ac)), 1.0):
            raise AssertionError(f"[lm] {arch} aux {float(ag)} vs "
                                 f"{float(ac)}")
        out["decode"] = max(_lm_logits_close(g[0], c[0], f"{arch} step {i}")
                            for i, (g, c) in enumerate(zip(sg, sc)))
        out["cache"] = max(_lm_caches_close(g[1], c[1], f"{arch} step {i}")
                           for i, (g, c) in enumerate(zip(sg, sc)))
        # greedy generate: tokens equal up to their first difference, where
        # every row that differs is at a near tie of the CPU's logits
        # (teacher-forced along its tokens)
        fe = None if frontend is None else frontend
        want = generate(cfg, cpu, prompts, 8, frontend=fe, device="cpu")
        got = generate(cfg, card, prompts, 8, device=dev,
                       frontend=None if fe is None else fe.to(dev))
        differs = np.flatnonzero((got != want).any(axis=0))
        same = int(differs[0]) if len(differs) else 8
        if same < 8:
            from repro_torch.serve.engine import prefill
            fed = torch.from_numpy(np.concatenate([prompts, want[:, :same]],
                                                  axis=1))
            logits, _ = prefill(cfg, cpu, fed, 12, fe)
            top = torch.topk(logits, 2, dim=-1).values
            rows = torch.from_numpy(got[:, same] != want[:, same])
            margin = float((top[:, 0] - top[:, 1])[rows].max())
            if margin > 2 * LM_ATOL:
                raise AssertionError(f"[lm] {arch}: generate differs at "
                                     f"step {same}, margin {margin}")
        out["generate_steps_equal"] = same
    return out


def _lm_device_busy(step, n):
    """(host ms per call, device ms per call, device busy share) over
    ``n`` calls of ``step()`` under ``torch.profiler``.  Device time is
    the time covered by the trace's device events (kernels, copies, sets:
    the events of device type CUDA), their intervals merged; the aten ops
    that launched them carry the same time as their own device time and
    are not counted again.  The share is that time over the wall time;
    the profiler's own host cost lengthens the wall, so it is a lower
    bound.  Device ms and share are None if the trace shows no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not busy_us:
        return wall / n * 1e3, None, None
    return wall / n * 1e3, busy_us * 1e-3 / n, busy_us * 1e-6 / wall


@contextlib.contextmanager
def _compute_dtype(layers, dtype):
    """The LM layers' compute dtype set to ``dtype`` for a check."""
    old = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = old


def _fp8_round(x):
    """``x`` rounded through float8 e4m3 (its range clamped first) and
    back to its dtype."""
    import torch
    return x.clamp(-448, 448).to(torch.float8_e4m3fn).to(x.dtype)


@contextlib.contextmanager
def _lm_fault(fault):
    """A known fault of the decode path, injected for a control reading of
    the bf16 prefill gate: ``cache_fp8`` rounds every float cache leaf
    through float8 after each decode step (a wrongly typed cache),
    ``act_fp8`` rounds every RMSNorm output, the input of each mixer, FFN
    and the unembedding, through float8 (decode computed in a lower
    precision), ``state_bf16`` keeps the SSM state bf16 between steps
    (not promoted to f32 at the first step)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def leaves(tree, leaf):
        return {k: leaves(v, leaf) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    def cache_fp8(k, v):
        return _fp8_round(v) if v.is_floating_point() else v

    def state_bf16(k, v):
        return v.to(torch.bfloat16) if k == "state" else v

    if fault == "act_fp8":
        patch, orig = (L, "rmsnorm"), L.rmsnorm

        def fn(*a, **kw):
            return _fp8_round(orig(*a, **kw))
    else:
        leaf = {"cache_fp8": cache_fp8, "state_bf16": state_bf16}[fault]
        patch, orig = (T, "decode_step"), T.decode_step

        def fn(cfg, params, cache, token):
            logits, cache = orig(cfg, params, cache, token)
            return logits, leaves(cache, leaf)
    setattr(*patch, fn)
    try:
        yield
    finally:
        setattr(*patch, orig)


def _lm_cache_dtype_faults(cache):
    """The float cache leaves not in the reference's dtypes after a decode
    step: the SSM state f32 (bf16 state x f32 decay promotes at the first
    step), every other float leaf bf16."""
    import torch
    return [k for k, v in _lm_leaves(cache).items() if v.is_floating_point()
            and v.dtype != (torch.float32 if k.split("/")[-1] == "state"
                            else torch.bfloat16)]


def _lm_bytes(params):
    return sum(p.numel() * p.element_size() for p in params.parameters())


def _lm_rms_rel(a, b):
    """RMS of a - b over the RMS of b, on the real vocabulary."""
    ok = b > -1e29
    d = (a.float() - b.float())[ok]
    return float(d.pow(2).mean().sqrt() / b.float()[ok].pow(2).mean().sqrt())


def lm_full(name, n_layers, dev, smi, cfg=None):
    """One model at full published width on ``dev``: seeded parameters
    from a generator on the device, prefill (held against ``lm_apply``,
    then timed), then ``generate`` of LM_STEPS greedy tokens for
    LM_BATCH prompts of LM_PROMPT seeded tokens (timed); MLA also decodes
    absorbed.  Frees the model before it returns."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serve import generate
    from repro_torch.serve.engine import prefill

    sync = torch.cuda.synchronize
    cfg = cfg or get_config(name)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, SEED, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    max_len = LM_PROMPT + LM_STEPS + 1
    rec = dict(model=name, layers=cfg.n_layers, published_layers=full_layers,
               d_model=cfg.d_model, param_bytes=_lm_bytes(params),
               init_s=round(init_s, 3))

    def clocked(fn):
        """fn()'s result and its seconds, from and to a synchronize."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def timed(prefix=""):
        """Decode = generate of LM_STEPS tokens less the prefill timed
        before it (the prompt's P decode steps, whose logits give the
        first token): its LM_STEPS - 1 decode steps more."""
        toks, rec[prefix + "generate_s"] = clocked(
            lambda: generate(cfg, params, prompts, LM_STEPS, device=dev))
        if toks.shape != (LM_BATCH, LM_STEPS) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"[lm] {name}: tokens {toks.shape}")
        rec[prefix + "decode_s"] = rec[prefix + "generate_s"] \
            - rec[prefix + "prefill_s"]
        rec[prefix + "decode_tokens_per_s"] = LM_BATCH * (LM_STEPS - 1) \
            / rec[prefix + "decode_s"]
        return toks

    with torch.no_grad():
        last, cache = prefill(cfg, params, prompts, max_len)
        rec["cache_dtype_faults"] = _lm_cache_dtype_faults(cache)
        del cache
        # MoE drops by capacity over the tokens routed together (B at a
        # decode step, B*S in the forward): the check runs MoE at a
        # capacity factor of n_experts, where nothing is dropped
        check_cfg = cfg if cfg.moe is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        step_last = last if cfg.moe is None else \
            prefill(check_cfg, params, prompts, max_len)[0]
        ref_last = T.lm_apply(check_cfg, params, prompts)[0][:, -1]
        with _compute_dtype(L, torch.float32):
            f32_last = T.lm_apply(check_cfg, params, prompts)[0][:, -1]
            f32_step = prefill(check_cfg, params, prompts, max_len)[0]
        rec["prefill_vs_lm_apply_f32"] = _lm_rms_rel(f32_step, f32_last)
        rec["prefill_vs_lm_apply"] = _lm_rms_rel(step_last, ref_last)
        rec["lm_apply_vs_f32"] = _lm_rms_rel(ref_last, f32_last)
        rec["prefill_vs_f32"] = _lm_rms_rel(step_last, f32_last)
        rec["prefill_top1_equal"] = int((step_last.argmax(-1)
                                         == ref_last.argmax(-1)).sum())
        if cfg.moe is not None:
            rec["published_capacity_vs_lm_apply"] = _lm_rms_rel(last,
                                                                ref_last)
        if cfg.mla is not None:
            L.MLA_ABSORBED_DECODE = True
            try:
                (abs_last, _), rec["absorbed_prefill_s"] = clocked(
                    lambda: prefill(cfg, params, prompts, max_len))
                with _compute_dtype(L, torch.float32):
                    f32_abs = prefill(cfg, params, prompts, max_len)[0]
            finally:
                L.MLA_ABSORBED_DECODE = False
            rec["absorbed_vs_naive_f32"] = _lm_rms_rel(f32_abs, f32_step)
            rec["absorbed_vs_naive"] = _lm_rms_rel(abs_last, last)
            rec["absorbed_vs_f32"] = _lm_rms_rel(abs_last, f32_last)
            del abs_last, f32_abs
        del ref_last, step_last, f32_step
        bound = LM_BF16_RATIO * rec["lm_apply_vs_f32"]
        bad = [k for k, lim in (
            ("prefill_vs_lm_apply_f32", LM_F32_TOL),
            ("absorbed_vs_naive_f32", LM_F32_TOL),
            ("prefill_vs_f32", bound), ("absorbed_vs_f32", bound))
            if k in rec and not rec[k] <= lim]
        bad += ["cache_dtype_faults"] if rec["cache_dtype_faults"] else []
        if bad:
            raise AssertionError(f"[lm] {name}: {bad} out of tolerance: "
                                 f"{rec}")
        # control readings: the same checks with a known fault in the
        # decode path (each must fail one of them, checked at the end)
        controls = {}
        for fault in LM_CONTROLS:
            if fault == "state_bf16" and cfg.ssm is None:
                continue
            with _lm_fault(fault):
                ctrl, ctrl_cache = prefill(check_cfg, params, prompts,
                                           max_len)
            ratio = _lm_rms_rel(ctrl, f32_last) / rec["lm_apply_vs_f32"]
            faults = len(_lm_cache_dtype_faults(ctrl_cache))
            rec[f"control_{fault}_ratio"] = ratio
            rec[f"control_{fault}_dtype_faults"] = faults
            controls[fault] = ratio > LM_BF16_RATIO or faults > 0
            del ctrl, ctrl_cache
        (_, cache), rec["prefill_s"] = clocked(
            lambda: prefill(cfg, params, prompts, max_len))
        toks = timed()
        if cfg.mla is not None:
            L.MLA_ABSORBED_DECODE = True
            try:
                abs_toks = timed("absorbed_")
            finally:
                L.MLA_ABSORBED_DECODE = False
            rec["absorbed_tokens_equal"] = int(
                (abs_toks == toks).all(axis=0).cumprod().sum())
        # the device's busy share over decode steps (host-bound or not)
        tok = toks[:, 0]
        (rec["profiled_step_ms"], rec["device_ms_per_step"],
         rec["device_busy_share"]) = _lm_device_busy(
            lambda: T.decode_step(cfg, params, cache, tok), LM_PROFILE_STEPS)
        # the same device time over an unprofiled decode step of generate
        if rec["device_ms_per_step"] is not None:
            rec["device_share_of_decode_step"] = rec["device_ms_per_step"] \
                / (rec["decode_s"] * 1e3 / (LM_STEPS - 1))
        del cache
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, last, f32_last
    torch.cuda.empty_cache()
    log("lm", **rec, smi=smi)
    blind = [f for f, seen in controls.items() if not seen]
    if blind:
        raise AssertionError(f"[lm] {name}: no check sees the faults "
                             f"{blind} (bf16 gate {LM_BF16_RATIO}x)")
    return rec


def _recurrence(x, a, B, C):
    """The SSM run token by token in f32: h_t = exp(a_t) h_{t-1} +
    x_t B_t^T, y_t = h_t C_t."""
    import torch
    b, l, h, p = x.shape
    st = torch.zeros((b, h, p, B.shape[-1]), device=x.device)
    ys = []
    for t in range(l):
        st = st * torch.exp(a[:, t])[..., None, None] \
            + x[:, t, :, :, None].float() * B[:, t, None, None, :].float()
        ys.append(torch.einsum("bhpn,bn->bhp", st, C[:, t].float()))
    return torch.stack(ys, dim=1)


def _moe_per_expert(cfg, params, x):
    """The capacity MoE as a loop over experts (positions in each queue
    from a cumulative count over a one-hot, not a sort): the plain
    formulation ``moe``'s sort-based dispatch is held against."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    mo = cfg.moe
    B, S, d = x.shape
    E, k = mo.n_experts, mo.top_k
    xt = x.reshape(B * S, d)
    # the router's logits by the same call as moe's (a top-k near tie
    # must not flip between two GEMMs that sum in another order)
    logits = L._einsum("bsd,de->bse", x, L.cast(params["router"])) \
        .float().reshape(B * S, E)
    gv, gi = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    gv = (gv / gv.sum(-1, keepdim=True)).to(x.dtype)
    cap = math.ceil(mo.capacity_factor * B * S * k / E)
    flat = gi.reshape(-1)
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = (pos < cap).reshape(B * S, k)
    out = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        tok, j = torch.nonzero((gi == e) & keep, as_tuple=True)
        if len(tok) == 0:
            continue
        xe = xt[tok]
        h = F.silu(xe @ params["wg"][e].to(x.dtype)) \
            * (xe @ params["wu"][e].to(x.dtype))
        y = h @ params["wd"][e].to(x.dtype)
        out.index_add_(0, tok, (y * gv[tok, j][:, None]).float())
    return out.to(x.dtype).reshape(B, S, d), int(keep.sum())


def lm_timing(dev, smi, flash=(1, 4096, 24, 8, 128), ssd=(1, 4096, 80, 64,
                                                         128, 256),
              moe_cfg=None, moe_tokens=(4, 1024), reps=3):
    """The LM substrate's jnp device programs, ported as torch ops, at
    full width with CUDA events, each beside its bound and checked:
    ``_flash_sdpa`` at minitron-4b's attention (against ``_sdpa``, with
    ``scaled_dot_product_attention`` timed as the library yardstick),
    ``ssd_chunked`` at mamba2-2.7b's (against the recurrence token by
    token), one ``moe`` layer of moonshot-v1-16b-a3b at B*S = 4096
    (against a loop over experts)."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    RL = _roofline()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    out = {}
    with torch.no_grad():
        # flash attention, causal, minitron-4b's heads
        B, S, H, Kv, hd = flash
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf16)
        k = torch.randn((B, S, Kv, hd), generator=gen, device=dev).to(bf16)
        v = torch.randn((B, S, Kv, hd), generator=gen, device=dev).to(bf16)
        got = L._flash_sdpa(q, k, v, True)
        mask = (torch.arange(S, device=dev)[:, None]
                >= torch.arange(S, device=dev)[None, :])[None, None, None]
        want = L._sdpa(q, k, v, mask)
        err = float((got.float() - want.float()).abs().max())
        tol = LM_LEAF_TOL * float(want.float().abs().max())
        del want, mask
        qh, kh, vh = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(H // Kv, 2), v.repeat_interleave(H // Kv,
                                                                    2)))
        lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        lib_err = float((lib.transpose(1, 2).float() - got.float())
                        .abs().max())
        if not (err <= tol and lib_err <= tol):
            raise AssertionError(f"[lm] _flash_sdpa: {err} vs _sdpa, "
                                 f"{lib_err} vs sdpa > {tol}")
        ms = cuda_ms(lambda: L._flash_sdpa(q, k, v, True), reps)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), reps)
        flops = 4 * B * H * hd * S * (S + 1) // 2
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Kv * hd)
        out["_flash_sdpa"] = _lm_bound_line(
            "_flash_sdpa", dict(B=B, S=S, H=H, Kv=Kv, hd=hd, causal=True),
            ms, flops, RL.H100_BF16_FLOPS, nbytes, smi, max_abs_err=err,
            tolerance=tol, library="scaled_dot_product_attention",
            library_ms=lib_ms, library_err=lib_err)
        del q, k, v, qh, kh, vh, lib, got

        # chunked SSD, mamba2-2.7b's heads (80 x 64, state 128, chunk 256)
        b, l, h, p, n, chunk = ssd
        x = torch.randn((b, l, h, p), generator=gen, device=dev).to(bf16)
        a = -(torch.rand((b, l, h), generator=gen, device=dev) * 0.49
              + 0.01)
        Bm = torch.randn((b, l, n), generator=gen, device=dev).to(bf16)
        Cm = torch.randn((b, l, n), generator=gen, device=dev).to(bf16)
        got = L.ssd_chunked(x, a, Bm, Cm, chunk)
        want = _recurrence(x, a, Bm, Cm)
        err = float((got - want).abs().max())
        tol = 1e-3 * float(want.abs().max())
        if not err <= tol:
            raise AssertionError(f"[lm] ssd_chunked vs recurrence {err} > "
                                 f"{tol}")
        del want
        ms = cuda_ms(lambda: L.ssd_chunked(x, a, Bm, Cm, chunk), reps)
        c = l // chunk
        flops = 2 * (c * chunk * chunk * n + c * h * chunk * chunk * p
                     + 2 * c * h * chunk * p * n + h * (c + 1) ** 2 * p * n)
        nbytes = x.numel() * 2 + a.numel() * 4 + 2 * Bm.numel() * 2 \
            + got.numel() * 4
        out["ssd_chunked"] = _lm_bound_line(
            "ssd_chunked", dict(b=b, l=l, h=h, p=p, n=n, chunk=chunk), ms,
            flops, RL.H100_F32_FLOPS, nbytes, smi, max_abs_err=err,
            tolerance=tol, library=None, library_ms=None)
        del x, a, Bm, Cm, got

        # one MoE layer of moonshot-v1-16b-a3b (64 experts, top 6)
        cfg = moe_cfg or get_config("moonshot-v1-16b-a3b")
        mo = cfg.moe
        params = {nm: (torch.randn(pm.shape, generator=gen, device=dev)
                       * 0.02) for nm, pm in L.moe_meta(cfg).items()}
        Bt, St = moe_tokens
        x = torch.randn((Bt, St, cfg.d_model), generator=gen,
                        device=dev).to(bf16)
        got, aux = L.moe(cfg, params, x)
        want, kept = _moe_per_expert(cfg, params, x)
        err = float((got.float() - want.float()).abs().max())
        tol = LM_LEAF_TOL * float(want.float().abs().max())
        if not err <= tol:
            raise AssertionError(f"[lm] moe vs per-expert loop {err} > "
                                 f"{tol}")
        ms = cuda_ms(lambda: L.moe(cfg, params, x), reps)
        d, fe, E = cfg.d_model, mo.d_expert, mo.n_experts
        flops = 2 * kept * 3 * d * fe + 2 * Bt * St * d * E
        nbytes = sum(t.numel() * 4 for t in params.values()) \
            + 2 * x.numel() * 2
        out["moe"] = _lm_bound_line(
            "moe", dict(tokens=Bt * St, d=d, experts=E, top_k=mo.top_k,
                        d_expert=fe, kept=kept, capacity=math.ceil(
                            mo.capacity_factor * Bt * St * mo.top_k / E)),
            ms, flops, RL.H100_BF16_FLOPS, nbytes, smi, max_abs_err=err,
            tolerance=tol, library=None, library_ms=None)
    return out


def _lm_bound_line(name, shape, ms, flops, rate, nbytes, smi, phase="lm",
                   **kw):
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / _roofline().HBM_BYTES_PER_S * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")
    rec = dict(program=name, ms=ms, bound_ms=bound, bound_by=by,
               flops=flops, bytes=nbytes, **kw)
    log(phase, **rec, shape=shape, smi=smi)
    return rec


def phase_lm(dev="cuda", archs=None, full=LM_FULL, full_cfgs=None,
             timing=None):
    """[lm]: the ten smoke architectures on the card against the CPU, one
    model per mixer family served at full published width, and the
    non-Pallas device programs timed beside their bounds."""
    from repro_torch.configs import ARCHS
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    for arch in archs or sorted(ARCHS):
        t0 = time.perf_counter()
        r = lm_smoke(arch, dev)
        log("lm", smoke=arch, seconds=round(time.perf_counter() - t0, 3),
            **r)
    for name, n_layers in full:
        lm_full(name, n_layers, dev, smi,
                cfg=(full_cfgs or {}).get(name))
    lm_timing(dev, smi, **(timing or {}))
    log("lm", seconds=round(time.perf_counter() - t_phase, 3), smi=smi)


# --------------------------------------------------------------------------
# [train]: the LM substrate's training (data/, train/, launch/, the monitor)
# --------------------------------------------------------------------------

# one train step's gradient, card against CPU at smoke size (bf16): the
# loss within TRAIN_LOSS_RTOL, each gradient leaf's RMS difference within
# TRAIN_RMS of its RMS and its largest within TRAIN_MAX of its largest
# magnitude -- the CPU tests' bounds for the port against the JAX package
# (largest seen there 1.5e-4, 0.037, 0.064).  The card against itself
# (microbatches=2 against the mean of its half-batch gradients, remat
# against none) within TRAIN_SAME of each leaf's largest magnitude: the
# same kernels, but the embedding's backward adds with atomics.  After one
# AdamW step from zero moments every update is about +-lr, so the two
# devices' parameters agree within TRAIN_STEP_LR x lr.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_RMS, TRAIN_MAX = 2.0 ** -4, 2.0 ** -3
TRAIN_SAME = 1e-4
TRAIN_STEP_LR = 2.5
# the restart check: the monitor's model (examples/train_topo_monitor_torch
# .py), its data (batch 8 x 64) and schedule, 10 steps against 5 + resume
TOPO_LM = dict(name="topo-lm", family="dense", n_layers=4, d_model=128,
               n_heads=4, n_kv=2, d_ff=512, vocab=2048)
# full width and depth: one chip's share (B 1) of the repo's train_4k shape
# (seq 4096, global batch 256 over a 16 x 16 mesh), 4 AdamW steps with
# remat on one fixed batch; the loss must fall
TRAIN_FULL = ("h2o-danube-3-4b", "mamba2-2.7b")
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 4
# directional derivative at step 0 in f32 compute: <g, d> against the
# four-point central difference (8 (L(h) - L(-h)) - (L(2h) - L(-2h))) /
# 12 h along a seeded direction d (N(0, 1) entries times 0.02, the init
# scale), L(s) the loss at p + s d.  Their difference is held to
# TRAIN_DIRDERIV_RTOL of 0.02 |g|, the spread of <g, d> over random
# directions (a d with <g, d> near 0 must not fail a sound gradient).  The
# two-point difference at h = 1e-2 missed by 0.9 % (h2o-danube-3-4b) and
# over 1 % (mamba2-2.7b) of that spread on the card, its h^2 curvature
# term; the four-point one cancels it, and its rounding (one f32 ulp of
# the loss, ~1e-6, times 1.5 / h) is about 1e-4 here.
TRAIN_DIRDERIV_H = 1e-2
TRAIN_DIRDERIV_RTOL = 1e-2
TRAIN_MONITOR_N = 16


def _leaf_rel(a, b):
    """One gradient leaf ``a`` against ``b``: (RMS difference over the RMS
    of ``b``, largest difference over the largest magnitude of ``b``,
    whether ``a`` is finite), computed on ``a``'s device."""
    import torch
    a, b = a.float(), b.float().to(a.device)
    d = (a - b).abs()
    top = max(float(b.abs().max()), 1e-30)
    rms = max(float(b.pow(2).mean().sqrt()), 1e-30)
    return (float(d.pow(2).mean().sqrt()) / rms, float(d.max()) / top,
            bool(torch.isfinite(a).all()))


def _leaf_bad(r, m, finite, bf16):
    """Past the tolerance (TRAIN_RMS and TRAIN_MAX if ``bf16``, else
    TRAIN_SAME), or not finite."""
    return not finite or ((r > TRAIN_RMS or m > TRAIN_MAX) if bf16
                          else m > TRAIN_SAME)


def _train_leaf_err(got, want, what, bf16):
    """(largest RMS-relative, largest max-relative) difference over the
    leaves of two gradient trees (:func:`_leaf_rel`); raises past the
    tolerance or on a value not finite (:func:`_leaf_bad`)."""
    from repro_torch.train.pytree import tree_leaves
    rms_err = max_err = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        r, m, finite = _leaf_rel(a, b)
        rms_err, max_err = max(rms_err, r), max(max_err, m)
        if _leaf_bad(r, m, finite, bf16):
            raise AssertionError(f"[train] {what}: leaf {i} rms {r} max {m}")
    return rms_err, max_err


def train_smoke(arch, dev):
    """One smoke architecture's train step on ``dev`` against the CPU from
    one seeded parameter tree: the gradient (bf16 tolerance), the card's
    microbatches=2 and remat against its own plain gradient, then one
    ``make_train_step`` on each device."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch_at
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax, params_to_numpy
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.pytree import tree_leaves, tree_map
    cfg = smoke_config(arch)
    cpu = T.init_params(cfg, SEED, device="cpu")
    card = params_from_jax(cfg, params_to_numpy(cpu), device=dev)
    batch = {k: torch.from_numpy(v) for k, v in host_batch_at(
        DataConfig(cfg.vocab, 2, 16, seed=SEED), 0).items()}
    fe = _lm_smoke_inputs(cfg, np.random.default_rng(
        zlib.crc32(arch.encode())))[2]
    if fe is not None:
        batch["frontend"] = fe.float()
    plain = TS.StepConfig(remat=False)

    def grads(params, d, sc=plain, b=batch):
        return TS.loss_and_grads(cfg, sc, params,
                                 {k: v.to(d) for k, v in b.items()})

    out = {}
    lc, _, gc = grads(cpu, "cpu")
    lg, _, gg = grads(card, dev)
    out["loss"] = float(lg)
    out["loss_vs_cpu"] = abs(float(lg) - float(lc)) / abs(float(lc))
    if not out["loss_vs_cpu"] <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"[train] {arch}: loss {float(lg)} vs "
                             f"{float(lc)}")
    out["grad_rms_vs_cpu"], out["grad_max_vs_cpu"] = _train_leaf_err(
        gg, gc, f"{arch} card vs CPU", True)
    _, _, g2 = grads(card, dev, TS.StepConfig(microbatches=2, remat=False))
    halves = [grads(card, dev, b={k: v[i:i + 1] for k, v in batch.items()})
              [2] for i in range(2)]
    mean = tree_map(lambda a, b: (a + b) / 2, *halves)
    out["microbatch_vs_halves"] = _train_leaf_err(
        g2, mean, f"{arch} microbatches=2 vs halves", False)[1]
    if cfg.moe is None:     # MoE capacity and aux depend on the tokens routed
        out["microbatch_vs_full_rms"] = _train_leaf_err(
            g2, gg, f"{arch} microbatches=2 vs 1", True)[0]
    _, _, gr = grads(card, dev, TS.StepConfig(remat=True))
    out["remat_vs_plain"] = _train_leaf_err(gr, gg, f"{arch} remat", False)[1]
    del gc, gg, g2, gr, halves, mean
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    step = TS.make_train_step(cfg, opt_cfg, plain)
    metrics = {}
    for name, p, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        _, _, metrics[name] = step(p, init_opt_state(p),
                                   {k: v.to(d) for k, v in batch.items()})
    for k, tol in (("loss", TRAIN_LOSS_RTOL), ("gnorm", TRAIN_RMS)):
        a, b = float(metrics["card"][k]), float(metrics["cpu"][k])
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"[train] {arch} step {k}: {a} vs {b}")
    out["step_param_diff_over_lr"] = max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(tree_leaves(card), tree_leaves(cpu))) / opt_cfg.lr
    if not out["step_param_diff_over_lr"] <= TRAIN_STEP_LR:
        raise AssertionError(f"[train] {arch}: parameters after one step "
                             f"{out['step_param_diff_over_lr']} lr apart")
    return out


def _mesh_unit_arch(arch, mesh, dev):
    """One smoke architecture's step-0 loss and gradient through the
    ``DTensor`` path on the (data=1, model=1) ``mesh`` (parameters placed
    by ``param_shardings``, the batch by ``batch_spec``, the rules
    installed), against the plain step on the same card from the same
    parameters (the card-vs-CPU tolerances: the same ops run on whole
    tensors, but the loss's log_softmax and the embedding's lookup take
    their vocab-parallel forms)."""
    import zlib
    import numpy as np
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch_at
    from repro_torch.models import transformer as T
    from repro_torch.train import sharding as SH
    from repro_torch.train import train_step as TS
    from repro_torch.train.pytree import tree_map
    cfg = smoke_config(arch)
    params = T.init_params(cfg, SEED, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host_batch_at(
        DataConfig(cfg.vocab, 2, 16, seed=SEED), 0).items()}
    fe = _lm_smoke_inputs(cfg, np.random.default_rng(
        zlib.crc32(arch.encode())))[2]
    if fe is not None:
        batch["frontend"] = fe.float().to(dev)
    plain = TS.StepConfig(remat=False)
    lw, _, gw = TS.loss_and_grads(cfg, plain, params, batch)
    rules = SH.ShardingRules()
    placed = SH.place_tree(params.tree(), SH.param_shardings(
        T.lm_meta(cfg), rules, mesh), mesh)
    rows = {k: SH.place_rows(v, len(v), rules, mesh)
            for k, v in batch.items()}
    SH.set_rules(rules, mesh)
    try:
        lg, _, gg = TS.loss_and_grads(cfg, plain, placed, rows)
    finally:
        SH.set_rules(None, None)
    out = dict(loss=float(lg), loss_vs_plain=abs(float(lg) - float(lw))
               / abs(float(lw)))
    if not out["loss_vs_plain"] <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"[train] {arch} on the (1, 1) mesh: loss "
                             f"{float(lg)} vs {float(lw)}")
    out["grad_rms_vs_plain"], out["grad_max_vs_plain"] = _train_leaf_err(
        tree_map(lambda g: g.full_tensor(), gg), gw,
        f"{arch} (1, 1) mesh vs plain", True)
    return out


def train_mesh_unit(dev, archs=None):
    """[train]'s mesh check on one card: a one-rank NCCL group
    (``file://`` rendezvous), a (data=1, model=1) ``DeviceMesh`` on it,
    and the smoke architectures' step 0 through the ``DTensor`` path
    against the plain step (:func:`_mesh_unit_arch`).  The group is
    destroyed before it returns."""
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ARCHS
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                              mesh_dim_names=("data", "model"))
            for arch in archs or sorted(ARCHS):
                t0 = time.perf_counter()
                r = _mesh_unit_arch(arch, mesh, dev)
                log("train", mesh_1x1=arch, backend="nccl",
                    seconds=round(time.perf_counter() - t0, 3), **r)
        finally:
            dist.destroy_process_group()


def _train_equal(a, b, what):
    """Every leaf of two trees equal bit for bit (both moved to the CPU)."""
    import torch
    from repro_torch.train.pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    bad = [i for i, (x, y) in enumerate(zip(la, lb))
           if not torch.equal(x.detach().cpu(), y.detach().cpu())]
    if bad or len(la) != len(lb):
        raise AssertionError(f"[train] {what}: leaves {bad} differ")
    return len(la)


def train_restart(dev, tmp):
    """The reference's fault-tolerance guarantee on the card, under
    deterministic algorithms: 10 steps of ``run`` against 5, a simulated
    crash and a resume to 10 -- every parameter and moment bit for bit --
    then a checkpoint of the card's state read back onto the CPU.  Returns
    (config, the trained parameters, the record)."""
    import os
    import torch
    from repro_torch.launch.train import RunConfig, run
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.pytree import tree_leaves
    cfg = ModelConfig(**TOPO_LM)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=10)
    rec = {}
    ck = os.path.join(tmp, "ck")

    def go(steps, ckpt_dir=None):
        return run(cfg, RunConfig(steps=steps, ckpt_every=5,
                                  ckpt_dir=ckpt_dir, seed=SEED), opt_cfg,
                   verbose=False, device=dev)

    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        p_full, o_full, l_full = go(10)
        rec["ten_steps_s"] = time.perf_counter() - t0
        _, _, l_half = go(5, ck)
        p_res, o_res, l_res = go(10, ck)
    finally:
        torch.use_deterministic_algorithms(False)
    if l_half + l_res != l_full:
        raise AssertionError(f"[train] restart losses {l_half + l_res} vs "
                             f"{l_full}")
    rec["leaves_equal"] = _train_equal(p_full, p_res, "restart params") \
        + _train_equal(o_full.m, o_res.m, "restart m") \
        + _train_equal(o_full.v, o_res.v, "restart v")
    rec["losses"] = [round(x, 4) for x in l_full]
    # control: the same 10 steps twice without deterministic algorithms
    p_a, _, _ = go(10)
    p_b, _, _ = go(10)
    rec["nondeterministic_leaves"] = sum(
        not torch.equal(a, b) for a, b in zip(tree_leaves(p_a),
                                              tree_leaves(p_b)))
    del p_a, p_b
    save_checkpoint(os.path.join(tmp, "card"), 10, p_res, o_res)
    step, p_cpu, o_cpu = load_checkpoint(os.path.join(tmp, "card"), p_res,
                                         o_res, device="cpu")
    rec["checkpoint_to_cpu_leaves_equal"] = _train_equal(
        p_cpu, p_res, "checkpoint params") + _train_equal(
        o_cpu.m, o_res.m, "checkpoint m") + _train_equal(
        o_cpu.v, o_res.v, "checkpoint v")
    if step != 10 or int(o_cpu.step) != 10:
        raise AssertionError(f"[train] checkpoint step {step}")
    return cfg, p_res, rec


def _train_dirderiv(cfg, params, batch, dev):
    """<g, d> against the four-point central difference of the loss along
    a seeded direction d, in f32 compute, at ``params`` (step 0).  d is
    drawn leaf by leaf from a generator seeded per leaf, so it is made
    again where needed and never held whole; the perturbed parameters
    live in one buffer, rewritten for each of the four points."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.pytree import tree_leaves, tree_map
    h = TRAIN_DIRDERIV_H
    sc = TS.StepConfig(remat=True)

    def direction(i, leaf):
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + i)
        return torch.randn(leaf.shape, generator=gen, device=dev) * 0.02

    t0 = time.perf_counter()
    with _compute_dtype(L, torch.float32):
        loss, _, grads = TS.loss_and_grads(cfg, sc, params, batch)
        grad_bytes = sum(g.untyped_storage().nbytes()
                         for g in tree_leaves(grads))
        gnorm = float(global_norm(grads))
        gd = 0.0
        for i, (g, p) in enumerate(zip(tree_leaves(grads),
                                       tree_leaves(params))):
            gd += float((g * direction(i, p)).sum(dtype=torch.float64))
        del grads
        with torch.no_grad():
            pert = tree_map(torch.empty_like, params)
            at = {}
            for s in (1, -1, 2, -2):
                for i, (q, p) in enumerate(zip(tree_leaves(pert),
                                               tree_leaves(params))):
                    torch.add(p, direction(i, p), alpha=s * h, out=q)
                at[s] = float(TS.loss_fn(cfg, sc, pert, batch["tokens"],
                                         batch["labels"])[0])
        del pert
    fd = (8 * (at[1] - at[-1]) - (at[2] - at[-2])) / (12 * h)
    spread = 0.02 * gnorm
    rec = dict(dirderiv_loss=float(loss), dirderiv_gnorm=gnorm,
               dirderiv_grad=gd, dirderiv_central=fd,
               dirderiv_two_point=(at[1] - at[-1]) / (2 * h),
               dirderiv_err_over_spread=abs(fd - gd) / max(spread, 1e-30),
               dirderiv_s=time.perf_counter() - t0, grad_bytes=grad_bytes)
    if not rec["dirderiv_err_over_spread"] <= TRAIN_DIRDERIV_RTOL:
        raise AssertionError(f"[train] {cfg.name}: directional derivative "
                             f"{gd} vs central difference {fd}")
    return rec


def train_full(name, dev, smi, cfg=None, seq=TRAIN_S):
    """One model trained at full published width and depth on ``dev``:
    seeded parameters made on the device, the directional-derivative
    check at step 0, then TRAIN_STEPS AdamW steps with remat on one fixed
    batch of TRAIN_B x ``seq`` tokens (the loss must fall), timed, with
    the device's busy share over one more profiled step.  Frees the model
    before it returns."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.pytree import tree_leaves
    sync = torch.cuda.synchronize
    cfg = cfg or get_config(name)
    n_params = sum(math.prod(x.shape) for x in
                   tree_leaves(T.abstract_params(cfg)))
    rec = dict(model=name, layers=cfg.n_layers, d_model=cfg.d_model,
               batch=TRAIN_B, seq=seq, params=n_params,
               # f32 parameters, gradients, m and v
               static_gb=16 * n_params / 1e9)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, SEED, device=dev)
    sync()
    rec["init_s"] = time.perf_counter() - t0
    batch = batch_at(DataConfig(cfg.vocab, TRAIN_B, seq, seed=SEED), 0,
                     device=dev)
    rec.update(_train_dirderiv(cfg, params, batch, dev))
    opt = init_opt_state(params)
    # the bytes the card holds for parameters, gradients (the step's
    # buffers, measured in the derivative check), m and v
    rec["static_bytes"] = rec.pop("grad_bytes") + sum(
        x.untyped_storage().nbytes()
        for tree in (params, opt.m, opt.v) for x in tree_leaves(tree))
    step_fn = TS.make_train_step(cfg, OptConfig(lr=1e-4, warmup_steps=1),
                                 TS.StepConfig(remat=True))
    losses, secs = [], []
    sync()
    before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    rec["step_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec.update(losses=losses, gnorm=float(m["gnorm"]),
               first_step_s=secs[0], step_s=sum(secs[1:]) / (len(secs) - 1))
    rec["tokens_per_s"] = TRAIN_B * seq / rec["step_s"]
    (rec["profiled_step_ms"], rec["device_ms_per_step"],
     rec["device_busy_share"]) = _lm_device_busy(
        lambda: step_fn(params, opt, batch), 1)
    # the same device time over an unprofiled step
    if rec["device_ms_per_step"] is not None:
        rec["device_share_of_step"] = rec["device_ms_per_step"] \
            / (rec["step_s"] * 1e3)
    rec["peak_gb"] = max(before, torch.cuda.max_memory_allocated()) / 1e9
    del params, opt, m, step_fn
    torch.cuda.empty_cache()
    log("train", **rec, smi=smi)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"[train] {name}: the loss did not fall: "
                             f"{losses}")
    return rec


def train_timing(dev, smi, flash=(1, 4096, 32, 8, 120, 4096),
                 ssd=(1, 4096, 80, 64, 128, 256), reps=3):
    """The backward passes of the reference's jnp device programs, ported
    as torch ops under autograd, at the full-width training shapes, with
    CUDA events (forward + backward less the forward, both with autograd
    recording), each beside its bound: ``_flash_sdpa`` at
    h2o-danube-3-4b's attention (S 4096, 32 / 8 heads, hd 120, causal,
    window 4096; its gradient held against ``_sdpa``'s, with
    ``scaled_dot_product_attention``'s backward as the library
    yardstick) and ``ssd_chunked`` at mamba2-2.7b's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    RL = _roofline()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    out = {}

    def rnd(shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype) \
            .requires_grad_()

    def fwd_bwd(fn, inputs, dout):
        return lambda: torch.autograd.grad(fn(), inputs, dout)

    B, S, H, Kv, hd, window = flash
    q, k, v = rnd((B, S, H, hd)), rnd((B, S, Kv, hd)), rnd((B, S, Kv, hd))
    do = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf16)

    def flash_fn():
        return L._flash_sdpa(q, k, v, True, window)
    got = fwd_bwd(flash_fn, (q, k, v), do)()
    pos = torch.arange(S, device=dev)
    mask = ((pos[:, None] >= pos[None, :])
            & (pos[:, None] - pos[None, :] < window))[None, None, None]
    want = torch.autograd.grad(L._sdpa(q, k, v, mask), (q, k, v), do)
    del mask
    err = max(float((a.float() - b.float()).abs().max()) for a, b in
              zip(got, want))
    tol = LM_LEAF_TOL * max(float(b.float().abs().max()) for b in want)
    del want, got
    if not err <= tol:
        raise AssertionError(f"[train] _flash_sdpa backward vs _sdpa's: "
                             f"{err} > {tol}")
    fwd = cuda_ms(flash_fn, reps)
    both = cuda_ms(fwd_bwd(flash_fn, (q, k, v), do), reps)
    rep = H // Kv
    qh = q.detach().transpose(1, 2).requires_grad_()
    kh = k.detach().repeat_interleave(rep, 2).transpose(1, 2) \
        .requires_grad_()
    vh = v.detach().repeat_interleave(rep, 2).transpose(1, 2) \
        .requires_grad_()
    doh = do.transpose(1, 2)

    def lib_fn():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib = cuda_ms(fwd_bwd(lib_fn, (qh, kh, vh), doh), reps) \
        - cuda_ms(lib_fn, reps)
    pairs = sum(min(i + 1, window) for i in range(S))   # causal, windowed
    flops = 8 * B * H * hd * pairs           # dV, dP, dQ, dK: 2x forward
    nbytes = 2 * 2 * (2 * B * S * H * hd + 2 * B * S * Kv * hd)
    out["_flash_sdpa"] = _lm_bound_line(
        "_flash_sdpa_backward", dict(B=B, S=S, H=H, Kv=Kv, hd=hd,
                                     causal=True, window=window),
        both - fwd, flops, RL.H100_BF16_FLOPS, nbytes, smi, phase="train",
        forward_ms=fwd, max_abs_err=err, tolerance=tol,
        library="scaled_dot_product_attention", library_ms=lib)
    del q, k, v, do, qh, kh, vh, doh

    b, l, h, p, n, chunk = ssd
    x = rnd((b, l, h, p))
    a = (-(torch.rand((b, l, h), generator=gen, device=dev) * 0.49
           + 0.01)).requires_grad_()
    Bm, Cm = rnd((b, l, n)), rnd((b, l, n))
    dy = torch.randn((b, l, h, p), generator=gen, device=dev)

    def ssd_fn():
        return L.ssd_chunked(x, a, Bm, Cm, chunk)
    grads = fwd_bwd(ssd_fn, (x, a, Bm, Cm), dy)()
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("[train] ssd_chunked backward: not finite")
    del grads
    fwd = cuda_ms(ssd_fn, reps)
    both = cuda_ms(fwd_bwd(ssd_fn, (x, a, Bm, Cm), dy), reps)
    c = l // chunk
    flops = 4 * (c * chunk * chunk * n + c * h * chunk * chunk * p
                 + 2 * c * h * chunk * p * n + h * (c + 1) ** 2 * p * n)
    nbytes = 2 * (x.numel() * 2 + a.numel() * 4 + 2 * Bm.numel() * 2) \
        + dy.numel() * 4
    out["ssd_chunked"] = _lm_bound_line(
        "ssd_chunked_backward", dict(b=b, l=l, h=h, p=p, n=n, chunk=chunk),
        both - fwd, flops, RL.H100_F32_FLOPS, nbytes, smi, phase="train",
        forward_ms=fwd, library=None, library_ms=None)
    return out


def train_monitor(dev, cfg, params):
    """The monitor of ``examples/train_topo_monitor_torch.py`` on the card:
    ``loss_landscape_pd`` at n = TRAIN_MONITOR_N through a ``TopoService``
    on the pipeline's default back-end (the fused kernel), on the restart
    model at its seeded start (the batch of step 0) and trained (the
    batch of step 9).  Each diagram's re-check is a cache hit that
    launches nothing; its arrays (pairs in value and order space,
    essential classes) equal the ``np`` back-end's on the same sampled
    values.  Returns (record, fused launches)."""
    import importlib.util
    import numpy as np
    import torch
    from repro_torch.cache import DiagramCache
    from repro_torch.core.grid import Grid
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T
    from repro_torch.pipeline import PersistencePipeline
    from repro_torch.serve import TopoService
    from repro_torch.train.train_step import StepConfig
    spec = importlib.util.spec_from_file_location(
        "train_topo_monitor_torch",
        os.path.join(HERE, "examples", "train_topo_monitor_torch.py"))
    M = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(M)
    n = TRAIN_MONITOR_N
    g = Grid.of(n, n)
    cases = (("start", T.init_params(cfg, SEED, device=dev), 0),
             ("trained", params, 9))
    rec = {}
    _zero_counts()
    with TopoService(cache=DiagramCache(max_bytes=32 << 20),
                     max_wait_s=0.0) as svc:
        for name, p, step in cases:
            batch = batch_at(DataConfig(cfg.vocab, 8, 64), step, device=dev)
            t0 = time.perf_counter()
            vals, d0 = M.loss_landscape_pd(cfg, p, batch,
                                           StepConfig(remat=False), svc, n=n)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            before = dict(LS.LAUNCHES)
            again = svc.diagram(vals.reshape(-1), grid=g)     # a cache hit
            if dict(LS.LAUNCHES) != before:
                raise AssertionError(f"[train] monitor {name}: the re-check "
                                     f"launched {dict(LS.LAUNCHES)}")
            want = PersistencePipeline("np", sandwich_backend="np",
                                       device="cpu").run(vals.reshape(-1),
                                                         grid=g)
            got, exp = again.arrays(), want.arrays()
            if sorted(got) != sorted(exp) or any(
                    not np.array_equal(got[k], exp[k],
                                       equal_nan=exp[k].dtype.kind == "f")
                    for k in exp):
                raise AssertionError(f"[train] monitor {name}: the diagram "
                                     f"differs from the np back-end's")
            np_d0 = want.pairs(0, min_persistence=0)
            if not np.array_equal(d0, np_d0[np_d0[:, 0] != np_d0[:, 1]]):
                raise AssertionError(f"[train] monitor {name}: D0 pairs "
                                     f"differ from the np back-end's")
            rec[name] = dict(landscape_s=round(secs, 3), d0_pairs=len(d0),
                             d1_pairs=len(want.pairs(1, min_persistence=0)),
                             essential_d0=len(want.essential(0)),
                             loss_min=float(vals.min()),
                             loss_max=float(vals.max()))
        hits = svc.stats.as_dict()["cache_hits"]
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    if launches != {"fused": len(cases), "prepass": 0, "fused_halo": 0} \
            or plain or hits != len(cases):
        raise AssertionError(f"[train] monitor launches {launches}, plain "
                             f"{plain}, cache hits {hits}")
    rec.update(n=n, launches=launches, plain=plain, cache_hits=hits)
    return rec, launches["fused"]


def phase_train(dev="cuda", archs=None, full=TRAIN_FULL, full_cfgs=None,
                timing=None, seq=TRAIN_S):
    """[train]: the ten smoke architectures' train steps on the card
    against the CPU, the restart bit for bit, two models trained at full
    width and depth, the backward passes timed beside their bounds, and the
    topology monitor through the fused kernel.  Returns the monitor's
    fused launches and the full-width records (for [plan])."""
    import tempfile
    from repro_torch.configs import ARCHS
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    for arch in archs or sorted(ARCHS):
        t0 = time.perf_counter()
        r = train_smoke(arch, dev)
        log("train", smoke=arch, seconds=round(time.perf_counter() - t0, 3),
            **r)
    train_mesh_unit(dev, archs)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg, params, r = train_restart(dev, tmp)
        log("train", restart=cfg.name, seconds=round(
            time.perf_counter() - t0, 3), **r)
    r, monitor_launches = train_monitor(dev, cfg, params)
    log("train", monitor=cfg.name, **r, smi=smi)
    del params
    recs = {name: train_full(name, dev, smi, cfg=(full_cfgs or {}).get(name),
                             seq=seq)
            for name in full}
    train_timing(dev, smi, **(timing or {}))
    log("train", seconds=round(time.perf_counter() - t_phase, 3), smi=smi)
    return monitor_launches, recs


# [train_mesh] (``--group`` on four cards): minitron-4b at its published
# width and depth (32 x 3072, 24 heads / 8 kv, vocab 256000), whose f32
# parameters, gradients, m and v (81.5 GB) fit no single card, trained on
# TRAIN_MESH_CARDS NCCL ranks, one per card, on each mesh of
# TRAIN_MESH_MESHES: TRAIN_MESH_B x TRAIN_S (one fixed batch), remat,
# TRAIN_STEPS AdamW steps (lr 1e-4, warmup 1, as [train]); the loss must be
# finite and fall and read the same on every rank.  Step 0 is held to the
# one-card reference (step 0's loss_and_grads on card 0 alone, the same
# seeded parameters and batch, microbatches=2 so that parameters,
# gradients and activations fit; its gradients kept on the host): the loss
# within TRAIN_LOSS_RTOL and the gradient norm within
# TRAIN_MESH_GNORM_RTOL, about ten times the 4.1e-4 and 4.2e-4 the two
# meshes read on 4 x H100 (bf16 compute, the sums in other orders).  Each
# gradient leaf, gathered to rank 0 one at a time, is logged beside the
# reference's: in bf16 at 32 layers two sum orders part by about 7 % of a
# leaf's RMS in every leaf alike (rounding carried through the depth), so
# the leaves are held where rounding is small: the same meshes and batch
# in f32 compute at the full width and TRAIN_MESH_F32_LAYERS layers (the
# one-card f32 reference does not fit at full depth), every leaf within
# TRAIN_SAME of its largest magnitude (:func:`_leaf_bad`), and the bf16
# readings at that depth logged beside.
TRAIN_MESH_MODEL = "minitron-4b"
TRAIN_MESH_CARDS = 4
TRAIN_MESH_MESHES = ((2, 2), (1, 4))
TRAIN_MESH_B = 2
TRAIN_MESH_GNORM_RTOL = 2.0 ** -8
TRAIN_MESH_F32_LAYERS = 8


def _local_bytes(tree):
    """Bytes of the storages this rank holds for the leaves of ``tree``
    (a ``DTensor``'s local shard)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.pytree import tree_leaves
    return sum((x.to_local() if isinstance(x, DTensor) else x)
               .untyped_storage().nbytes() for x in tree_leaves(tree))


def _reset_peak():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _train_mesh_data():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    cfg = get_config(TRAIN_MESH_MODEL)
    return cfg, DataConfig(cfg.vocab, TRAIN_MESH_B, TRAIN_S, seed=SEED)


def _train_mesh_reference(cfg, data_cfg, dev):
    """Step 0 on one card alone: the seeded parameters and the batch,
    ``loss_and_grads`` with microbatches=2 and remat.  Returns its record
    (loss, gradient norm, seconds, peak) and its gradient leaves, moved to
    the host."""
    import torch
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import transformer as T
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.pytree import tree_leaves
    _reset_peak()
    params = T.init_params(cfg, SEED, device=dev)
    batch = batch_at(data_cfg, 0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = TS.loss_and_grads(
        cfg, TS.StepConfig(microbatches=2, remat=True), params, batch)
    gnorm = float(global_norm(grads))
    torch.cuda.synchronize()
    rec = dict(loss=float(loss), gnorm=gnorm,
               seconds=time.perf_counter() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    host = [g.cpu() for g in tree_leaves(grads)]
    del params, grads, batch
    _reset_peak()
    return rec, host


def _gathered_leaf_errs(grads, ref_grads):
    """Each leaf of the ``DTensor`` tree ``grads`` gathered in turn (a
    collective: every rank calls this) and, where ``ref_grads`` (the
    reference's leaves) is given, measured against it
    (:func:`_leaf_rel`); no gathered leaf outlives the call."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train.pytree import tree_leaves
    errs = []
    for i, g in enumerate(tree_leaves(grads)):
        whole = g.full_tensor() if isinstance(g, DTensor) else g
        if ref_grads is not None:
            errs.append(_leaf_rel(whole, ref_grads[i]))
    return errs


def _train_mesh_run(cfg, data_cfg, shape, dev, ref_grads, steps=True):
    """One mesh's run on this rank: seeded parameters made leaf by leaf and
    placed (``init_placed``), moments placed alike, step 0's
    ``loss_and_grads`` (its loss, gradient norm and gradient buffers; each
    gradient leaf gathered in turn, every rank taking part, and on rank 0,
    which holds the reference's leaves ``ref_grads``, measured against it
    by :func:`_leaf_rel`), then, with ``steps``, TRAIN_STEPS AdamW steps on
    the batch of step 0, each rank building its rows
    (``launch.train.mesh_batch``), timed; static bytes and the peak over
    the steps."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.train import mesh_batch, mesh_rules
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import ParamTree
    from repro_torch.train import sharding as SH
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import (OptConfig, global_norm,
                                             init_opt_state)
    mesh = DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))
    rules = mesh_rules(mesh)
    _reset_peak()
    t0 = time.perf_counter()
    params = ParamTree(SH.init_placed(T.lm_meta(cfg), SEED, rules, mesh,
                                      SH.mesh_device(mesh)))
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    rec = dict(mesh=list(shape), init_s=time.perf_counter() - t0)
    batch = mesh_batch(cfg, data_cfg, 0, mesh, rules)
    sc = TS.StepConfig(remat=True)
    step_fn = TS.make_train_step(cfg, OptConfig(lr=1e-4, warmup_steps=1), sc)
    SH.set_rules(rules, mesh)
    try:
        t0 = time.perf_counter()
        loss, _, grads = TS.loss_and_grads(
            cfg, sc, params, {k: v for k, v in batch.items()
                              if v is not None})
        rec.update(loss0=float(loss), gnorm0=float(global_norm(grads)),
                   grads_s=time.perf_counter() - t0)
        rec["static_bytes"] = _local_bytes(grads) + _local_bytes(params) \
            + _local_bytes(opt.m) + _local_bytes(opt.v)
        rec["leaf_errs"] = _gathered_leaf_errs(grads, ref_grads)
        del grads
        if not steps:
            return rec
        torch.cuda.synchronize()
        rec["before_steps_peak_bytes"] = torch.cuda.max_memory_allocated()
        _reset_peak()
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        rec["step_peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        SH.set_rules(None, None)
    rec.update(losses=losses, gnorm=float(m["gnorm"]), first_step_s=secs[0],
               step_s=sum(secs[1:]) / (len(secs) - 1))
    rec["tokens_per_s"] = data_cfg.batch * data_cfg.seq / rec["step_s"]
    del params, opt, m, batch
    _reset_peak()
    return rec


def _train_mesh_rank(rank, world, init, root, out_dir):
    """One rank of [train_mesh] on card ``rank``: rank 0 runs the one-card
    reference first (the others wait), then every mesh; then step 0 alone
    at TRAIN_MESH_F32_LAYERS layers in f32 and in bf16 compute, the same
    way (records ``f32/2x2`` ...); writes its records to
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, os.path.join(root, "src"))
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.models import layers
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world)
    try:
        cfg, data_cfg = _train_mesh_data()
        recs, ref_grads = {"rank": rank, "device": str(dev)}, None
        if rank == 0:
            recs["reference"], ref_grads = _train_mesh_reference(
                cfg, data_cfg, dev)
        dist.barrier()
        for shape in TRAIN_MESH_MESHES:
            recs["x".join(map(str, shape))] = _train_mesh_run(
                cfg, data_cfg, shape, dev, ref_grads)
        cut = dataclasses.replace(cfg, n_layers=TRAIN_MESH_F32_LAYERS)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            ref_grads = None
            with _compute_dtype(layers, dtype):
                if rank == 0:
                    recs[name + "/reference"], ref_grads = \
                        _train_mesh_reference(cut, data_cfg, dev)
                dist.barrier()
                for shape in TRAIN_MESH_MESHES:
                    recs[name + "/" + "x".join(map(str, shape))] = \
                        _train_mesh_run(cut, data_cfg, shape, dev, ref_grads,
                                        steps=False)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(recs, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def train_mesh(smi):
    """[train_mesh]: TRAIN_MESH_CARDS ranks, one per card, each mesh of
    TRAIN_MESH_MESHES in turn (see TRAIN_MESH_MODEL); one line per rank
    and mesh (static bytes, peak, step seconds, tokens per second, losses,
    gradient norm) beside ``nvidia-smi``'s name and power limit.  Returns
    every rank's records (for the plan).  With fewer cards a line says it
    did not run."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    world = TRAIN_MESH_CARDS
    if torch.cuda.device_count() < world:
        log("train_mesh", cards=torch.cuda.device_count(),
            run=f"not run: it needs {world} cards")
        return None
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_train_mesh_rank, nprocs=world, join=True, args=(
            world, "file://" + os.path.join(tmp, "rendezvous"), HERE, tmp))
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    ref = ranks[0]["reference"]
    log("train_mesh", reference=TRAIN_MESH_MODEL, device=ranks[0]["device"],
        microbatches=2, **ref, smi=smi)
    for shape in TRAIN_MESH_MESHES:
        key = "x".join(map(str, shape))
        for r in ranks:
            rec = dict(r[key])
            rec.pop("leaf_errs")
            log("train_mesh", model=TRAIN_MESH_MODEL, rank=r["rank"],
                device=r["device"], **rec, smi=smi)
            losses = rec["losses"]
            if not (all(math.isfinite(x) for x in losses)
                    and losses[-1] < losses[0]):
                raise AssertionError(f"[train_mesh] {key} rank {r['rank']}:"
                                     f" the loss did not fall: {losses}")
            if losses != ranks[0][key]["losses"]:
                raise AssertionError(f"[train_mesh] {key}: rank "
                                     f"{r['rank']} read other losses")
        rec = ranks[0][key]
        errs = rec["leaf_errs"]
        loss_rel = abs(rec["loss0"] - ref["loss"]) / abs(ref["loss"])
        gnorm_rel = abs(rec["gnorm0"] - ref["gnorm"]) / abs(ref["gnorm"])
        log("train_mesh", mesh=key, loss0=rec["loss0"],
            reference_loss=ref["loss"], loss_rel=loss_rel,
            tolerance=TRAIN_LOSS_RTOL, gnorm0=rec["gnorm0"],
            reference_gnorm=ref["gnorm"], gnorm_rel=gnorm_rel,
            gnorm_tolerance=TRAIN_MESH_GNORM_RTOL, leaves=len(errs),
            grad_rms_vs_reference=max(e[0] for e in errs),
            grad_max_vs_reference=max(e[1] for e in errs),
            same_losses_every_rank=True, smi=smi)
        if not loss_rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"[train_mesh] {key}: step-0 loss "
                                 f"{rec['loss0']} vs {ref['loss']}")
        if not gnorm_rel <= TRAIN_MESH_GNORM_RTOL:
            raise AssertionError(f"[train_mesh] {key}: step-0 gradient "
                                 f"norm {rec['gnorm0']} vs {ref['gnorm']}")
        if not all(e[2] for e in errs):
            raise AssertionError(f"[train_mesh] {key}: a step-0 gradient "
                                 "leaf is not finite")
        cut = {}
        for name in ("f32", "bf16"):
            c, want = ranks[0][f"{name}/{key}"], ranks[0][f"{name}/reference"]
            cut[name] = dict(
                loss_rel=abs(c["loss0"] - want["loss"]) / abs(want["loss"]),
                grad_rms=max(e[0] for e in c["leaf_errs"]),
                grad_max=max(e[1] for e in c["leaf_errs"]),
                reference_peak_bytes=want["peak_bytes"])
        log("train_mesh", mesh=key, layers=TRAIN_MESH_F32_LAYERS,
            step0_vs_reference=cut, f32_leaf_tolerance=TRAIN_SAME, smi=smi)
        errs = ranks[0][f"f32/{key}"]["leaf_errs"]
        bad = [(i, e) for i, e in enumerate(errs) if _leaf_bad(*e, False)]
        if bad or not errs:
            raise AssertionError(f"[train_mesh] {key}: f32 step-0 gradient "
                                 f"leaves (index, rms, max, finite) {bad} "
                                 f"of {len(errs)}")
    log("train_mesh", seconds=round(time.perf_counter() - t_phase, 3),
        smi=smi)
    return ranks


# [plan]: the planned peak of a train step at mesh (1, 1) is held to within
# PLAN_PEAK_RTOL of what [train] measured on the card (max_memory_allocated
# over its steps), and its static bytes to the byte.  The paper's field
# (DDMS_FIELDS["paper_6b"], 2048 x 1920 x 1536) in PLAN_BLOCKS blocks: one
# block (PLAN_BLOCK: its 6 owned planes and 2 ghosts) goes through the
# fused kernel's halo entry.  The field is a generated stand-in (the
# paper's Turbulent Channel Flow data is not in the repository): `wavelet`,
# whose closed form evaluates those planes of the 6-billion-vertex grid in
# seconds; the rng-backed fields replay their stream from the grid's start
# (some 6e9 draws, minutes on one core).
# The same tolerance holds the DDMS plan of [dist]'s run_front (isabel
# 256^3 in 8 blocks) to that run's own peak.
PLAN_PEAK_RTOL = 0.10
# Most of that peak is the static bytes, held to the byte above, so the
# part the counter models (the peak above the static bytes: activations,
# the step's temporaries, the batch) is gated on its own.  Against an
# H100 80GB HBM3 at 700 W the plan reads -1.2 % (h2o-danube-3-4b) and
# -1.0 % (mamba2-2.7b) there; a plan with no dynamic part reads -100 %.
PLAN_DYNAMIC_RTOL = 0.05
PLAN_FIELD = "wavelet"
PLAN_BLOCKS, PLAN_BLOCK = 256, 128
PLAN_PLAIN_PLANES = 2


def _plan_line(rec, **kw):
    ma = rec["memory_analysis"]
    log("plan", cell=f"{rec['arch']} x {rec['shape']}", mesh=rec["mesh"],
        devices=rec["n_devices"],
        argument_bytes=ma["argument_size_in_bytes"],
        output_bytes=ma["output_size_in_bytes"],
        temp_bytes=ma["temp_size_in_bytes"],
        peak_bytes=rec.get("peak_bytes_per_device"),
        flops=rec["flops_per_device"], bytes=rec["bytes_per_device"],
        collective_bytes=sum(v for k, v in rec["collectives"].items()
                             if k not in ("count", "seconds")),
        compute_ms=rec["compute_s"] * 1e3, memory_ms=rec["memory_s"] * 1e3,
        collective_ms=rec["collective_s"] * 1e3, dominant=rec["dominant"],
        useful_ratio=rec["useful_ratio"], count_s=round(rec["compile_s"], 3),
        **kw)


def plan_cells(archs=None):
    """The planner on this host for every architecture at ``train_4k`` on
    the single production mesh (full published widths, full depth by
    extrapolation) and the DDMS fields on both field meshes; one line per
    cell.  A cell that errors raises."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as D
    for arch in archs or sorted(ARCHS):
        rec = D.lower_cell(arch, "train_4k", False)
        _plan_line(rec, counted_on=rec["counted_on"])
    for fld in D.DDMS_FIELDS:
        for multi in (False, True):
            _plan_line(D.lower_ddms(fld, multi))


def plan_vs_train(train_recs, cfgs=None):
    """The plan of [train]'s full-width steps at mesh (1, 1), B x S and
    remat as [train] ran them, held to its figures from this run: static
    bytes equal to the card's, the planned peak within PLAN_PEAK_RTOL of
    the steps' ``max_memory_allocated`` and its part above the static
    bytes within PLAN_DYNAMIC_RTOL of the card's; the counted FLOPs
    beside the profiler's device ms per step (achieved FLOP/s against the
    bf16 peak).  Then one smoke step counted on fake CUDA and on fake CPU
    tensors: equal FLOPs (bytes and peak logged)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import sharding as SH
    from repro_torch.train.train_step import StepConfig
    RL = _roofline()
    unit = {"data": 1, "model": 1}
    for name, tr in train_recs.items():
        cfg = (cfgs or {}).get(name) or get_config(name)
        shape = ShapeSpec(f"train_{tr['batch']}x{tr['seq']}", tr["seq"],
                          tr["batch"], "train")
        p = D.plan_cell(cfg, shape, unit, StepConfig(remat=True),
                        exact=False)
        peak, card = p["peak_bytes_per_device"], tr["step_peak_bytes"]
        static = tr["static_bytes"]
        rel = (peak - card) / card
        # the part the counter models: the peak above the static bytes
        dyn_rel = (peak - card) / (card - static)
        dev_ms = tr.get("device_ms_per_step")
        achieved = p["flops_per_device"] / (dev_ms * 1e-3) if dev_ms \
            else None
        log("plan", train=name, batch=tr["batch"], seq=tr["seq"],
            planned_static_bytes=p["static_bytes_per_device"],
            card_static_bytes=tr["static_bytes"],
            planned_peak_bytes=peak, card_step_peak_bytes=card,
            peak_rel_err=round(rel, 4), tolerance=PLAN_PEAK_RTOL,
            planned_dynamic_bytes=peak - static,
            card_dynamic_bytes=card - static,
            dynamic_rel_err=round(dyn_rel, 4),
            dynamic_tolerance=PLAN_DYNAMIC_RTOL,
            static_only_rel_err=round((static - card) / card, 4),
            argument_bytes=p["memory_analysis"]["argument_size_in_bytes"],
            counted_flops=p["flops_per_device"],
            model_flops=p["model_flops_per_device"],
            counted_bytes=p["bytes_per_device"],
            memory_bound_ms=p["memory_s"] * 1e3,
            device_ms_per_step=dev_ms,
            achieved_tflops=achieved and achieved / 1e12,
            of_peak=achieved and achieved / RL.H100_BF16_FLOPS,
            counted_on=p["counted_on"], count_s=round(p["compile_s"], 3))
        if p["static_bytes_per_device"] != tr["static_bytes"]:
            raise AssertionError(f"[plan] {name}: planned static bytes "
                                 f"{p['static_bytes_per_device']} != the "
                                 f"card's {tr['static_bytes']}")
        if not abs(rel) <= PLAN_PEAK_RTOL:
            raise AssertionError(f"[plan] {name}: planned peak {peak} vs "
                                 f"the card's {card} ({rel:+.3f})")
        if not abs(dyn_rel) <= PLAN_DYNAMIC_RTOL:
            raise AssertionError(f"[plan] {name}: planned peak above the "
                                 f"static bytes {peak - static} vs the "
                                 f"card's {card - static} ({dyn_rel:+.3f})")
    cfg = smoke_config("minitron-4b")
    shape = ShapeSpec("smoke", 64, 2, "train")
    both = {d: D.count_step(cfg, shape, unit, SH.ShardingRules(),
                            device=d) for d in ("cuda", "cpu")}
    log("plan", counted_on={d: {k: r[k] for k in ("flops", "bytes", "peak",
                                                 "ops")}
                            for d, r in both.items()})
    if both["cuda"]["flops"] != both["cpu"]["flops"]:
        raise AssertionError("[plan] FLOPs counted on fake CUDA and CPU "
                             "tensors differ")


def plan_vs_train_mesh(ranks):
    """The plan of [train_mesh]'s step on each of its meshes (``plan_cell``
    at B x S and remat as it ran, the mesh as a mapping), held to every
    rank's figures from this run: the static bytes equal, the peak
    within PLAN_PEAK_RTOL of the rank's ``max_memory_allocated`` over the
    steps; the record's ``coinciding_sizes`` (model-axis sizes the
    counter cannot tell from replicated ones) logged beside."""
    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.train_step import StepConfig
    cfg, data_cfg = _train_mesh_data()
    b, seq = data_cfg.batch, data_cfg.seq
    shape = ShapeSpec(f"train_{b}x{seq}", seq, b, "train")
    for d, m in TRAIN_MESH_MESHES:
        key = f"{d}x{m}"
        tr = ranks[0][key]
        p = D.plan_cell(cfg, shape, {"data": d, "model": m},
                        StepConfig(remat=True), exact=False)
        peak, static = p["peak_bytes_per_device"], \
            p["static_bytes_per_device"]
        statics = [r[key]["static_bytes"] for r in ranks]
        peaks = [r[key]["step_peak_bytes"] for r in ranks]
        rels = [(peak - c) / c for c in peaks]
        log("plan", train_mesh=key, model=cfg.name, batch=b, seq=seq,
            planned_static_bytes=static,
            card_static_bytes=statics, planned_peak_bytes=peak,
            card_step_peak_bytes=peaks, peak_rel_err=[round(x, 4)
                                                      for x in rels],
            tolerance=PLAN_PEAK_RTOL,
            planned_dynamic_bytes=peak - static,
            card_dynamic_bytes=[c - static for c in peaks],
            coinciding_sizes=p["coinciding_sizes"],
            counted_flops=p["flops_per_device"],
            collective_ms=p["collective_s"] * 1e3, dominant=p["dominant"],
            step_s=tr["step_s"], counted_on=p["counted_on"],
            count_s=round(p["compile_s"], 3))
        if any(c != static for c in statics):
            raise AssertionError(f"[plan] {key}: planned static bytes "
                                 f"{static} != the ranks' {statics}")
        if not all(abs(x) <= PLAN_PEAK_RTOL for x in rels):
            raise AssertionError(f"[plan] {key}: planned peak {peak} vs "
                                 f"the ranks' {peaks}")


def plan_vs_dist(front):
    """The DDMS plan of [dist]'s ``run_front`` (``isabel`` 256^3, sample
    sort at the slack that run took, the derived triplet capacity, its
    ring rotations), held to what it measured: the planned peak (blocks x
    per-block argument, output and temp) within PLAN_PEAK_RTOL of the
    run's own peak (``max_memory_allocated`` less what lay on the card
    before the call: the whole field, [dist]'s oracles and references,
    logged apart); and the tet passes' bytes (successors + tet ring
    resolution) over HBM against their seconds: their byte bound beside
    their time."""
    from repro_torch.launch import dryrun as D
    RL = _roofline()
    nb = front["blocks"]
    rec = D.plan_ddms(front["dims"], {"data": nb}, crit_cap=None,
                      ring_rotations=None,
                      rotations=front["ring_rotations"],
                      sort_slack=front["sort_slack"])
    ma, by = rec["memory_analysis"], rec["bytes_detail"]
    tet = nb * (by["successors"] + by["resolution_t"])
    steps = front["steps"]
    planned = nb * sum(ma.values())
    run_peak = front["run_peak_bytes"]
    rel = (planned - run_peak) / run_peak
    nx, ny, nz = front["dims"]
    log("plan", ddms="isabel", dims=front["dims"], blocks=nb,
        sort_slack=front["sort_slack"],
        rotations=rec["config"]["rotations"],
        crit_capacity=rec["config"]["crit_capacity"],
        argument_bytes=nb * ma["argument_size_in_bytes"],
        output_bytes=nb * ma["output_size_in_bytes"],
        temp_bytes=nb * ma["temp_size_in_bytes"],
        phase_bytes={k: nb * v for k, v in rec["phase_bytes"].items()},
        planned_peak_bytes=planned, run_peak_bytes=run_peak,
        peak_rel_err=round(rel, 4), tolerance=PLAN_PEAK_RTOL,
        measured_peak_bytes=front["peak_device_bytes"],
        # outside the per-block model: what the card held before the
        # call, the whole f32 field among it; a LocalRing's gathered
        # outputs are the blocks' own tensors (no copy)
        outside_model_bytes=front["baseline_device_bytes"],
        whole_field_bytes=nx * ny * nz * 4, gathered_output_copy_bytes=0,
        bytes_by_pass={k: nb * v for k, v in by.items()},
        tet_pass_bytes=tet,
        tet_bound_ms=tet / RL.HBM_BYTES_PER_S * 1e3,
        successors_s=steps.get("successors"),
        resolution_s=steps.get("resolution"),
        run_front_s=front["seconds"])
    if abs(rel) > PLAN_PEAK_RTOL:
        raise AssertionError(f"[plan] run_front: planned peak {planned} vs "
                             f"the run's {run_peak} ({rel:+.2%}, tolerance "
                             f"{PLAN_PEAK_RTOL:.0%})")


def plan_block(smi, dims=(2048, 1920, 1536), n_blocks=PLAN_BLOCKS,
               block=PLAN_BLOCK, field=PLAN_FIELD):
    """One block of the paper's field at its per-device size through the
    halo entry (``ls_fused_halo_i32``): the owned planes and their two
    ghosts generated with ``make_field_chunk``, ranked by value with ties
    broken by vertex id (the order of this volume keeps every owned
    vertex's lower star as the global order would); the launch counted
    (zeroed just before, read just after); its rows equal to the plain
    version's on the same volume (run over slabs of PLAN_PLAIN_PLANES
    owned planes, timed with the clock) and to the fused in-memory
    entry's on the same volume's owned planes; then timed with CUDA
    events beside its bound.  Returns (halo launches, record)."""
    import torch
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.fields.generators import make_field_chunk
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ops, ref
    nx, ny, nz = dims
    nzl = nz // n_blocks
    z0 = block * nzl
    plane = nx * ny
    t0 = time.perf_counter()
    vol = make_field_chunk(field, dims, SEED, z0 - 1, z0 + nzl + 1)
    gen_s = time.perf_counter() - t0
    ranks = vertex_order(torch.from_numpy(vol).cuda()).to(torch.int32) \
        .reshape(vol.shape)
    del vol
    n = ranks.numel()
    torch.cuda.synchronize()
    _zero_counts()
    rows = LS.fused_rows_from_halo_volume(ranks, rank_bound=n)
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    if launches != {"fused": 0, "prepass": 0, "fused_halo": 1} or plain:
        raise AssertionError(f"[plan] block launches {launches} (plain "
                             f"{plain}); want the halo entry once")
    # the plain version on the same volume, PLAN_PLAIN_PLANES owned planes
    # (with their two ghosts) at a time, its launches not counted
    t0 = time.perf_counter()
    parts = [ops.lower_star_rows_halo(
        ranks[z - 1: min(z + PLAN_PLAIN_PLANES, nzl + 1) + 1], "torch")
        for z in range(1, nzl + 1, PLAN_PLAIN_PLANES)]
    plain_rows = tuple(torch.cat(p) for p in zip(*parts))
    del parts
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = _rows_equal(rows, plain_rows)
    del plain_rows
    whole = LS.fused_lower_star_gradient(Grid.of(nx, ny, nzl + 2),
                                         ranks.reshape(-1))
    _rows_equal(rows, tuple(t[plane: plane * (nzl + 1)] for t in whole),
                "the fused entry")
    del whole
    work = pairing_work(rows[0], rows[2])
    del rows
    work["bytes"] = _roofline().io_bytes(nzl * plane, 4, False,
                                         ghosts=2 * plane)
    ms = cuda_ms(lambda: LS.fused_rows_from_halo_volume(ranks, rank_bound=n),
                 reps=3)
    bms, by = bound_ms(work)
    rec = dict(field=field, dims=dims, blocks=n_blocks, block=block,
               planes=(z0 - 1, z0 + nzl + 1), vertices=n,
               owned=nzl * plane, generate_s=round(gen_s, 3), ms=ms,
               plain_ms=plain_s * 1e3,
               bound_ms=bms, bound_by=by, bytes=work["bytes"],
               ops=work["ops"], pops_per_vertex=work["pops_per_vertex"],
               max_abs_err=err, launches=launches["fused_halo"])
    log("plan", halo_block=rec, smi=smi)
    del ranks
    torch.cuda.empty_cache()
    return launches["fused_halo"], rec


def phase_plan(train_recs, front, archs=None, cfgs=None, block=None):
    """[plan]: the planner's full cells, its plan at mesh (1, 1) held to
    [train]'s figures, its DDMS plan beside [dist]'s, and one block of the
    paper's field through the halo entry.  Returns the halo launches."""
    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    plan_cells(archs)
    plan_vs_train(train_recs, cfgs)
    plan_vs_dist(front)
    launches, _ = plan_block(smi, **(block or {}))
    log("plan", seconds=round(time.perf_counter() - t_phase, 3), smi=smi)
    return launches


def phase_timing(isabel_256, report, plain=True):
    """CUDA-event times of both kernels on the [timing] fields, each beside
    its bound; ``report`` ([ptxas] phase) adds the launch shape, and
    ``plain`` times the plain version at 256^3 ``isabel``."""
    import torch
    from repro_torch.core.gradient import neighbor_orders
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    RL = _roofline()
    smi = nvidia_smi_line()
    records = {}
    g256 = Grid.of(256, 256, 256)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fields = {("isabel", 256): torch.from_numpy(isabel_256).cuda(),
              ("random", 256): torch.randn(g256.nv, generator=gen,
                                           device="cuda"),
              ("random", 512): torch.randn(512 ** 3, generator=gen,
                                           device="cuda")}
    shape = {k: {x: report[(k, "int32")][x] for x in
                 ("block", "registers", "stack_bytes", "static_smem",
                  "dynamic_smem", "blocks_per_sm")} if report else {}
             for k in ("fused", "prepass")}
    for (name, n), f in fields.items():
        g = Grid.of(n, n, n)
        o = vertex_order(f).to(torch.int32)
        del f
        out = LS.fused_lower_star_gradient(g, o)
        work = pairing_work(out[0], out[2])
        del out
        nb = neighbor_orders(g, o)
        runs = {"fused": (lambda: LS.fused_lower_star_gradient(g, o),
                          dict(work, bytes=RL.io_bytes(g.nv, 4, False))),
                "prepass": (lambda: LS.lower_star_gradient_prepass(
                    nb, o, rank_bound=g.nv),
                    dict(work, bytes=RL.io_bytes(g.nv, 4, True)))}
        for kernel, (fn, w) in runs.items():
            ms = cuda_ms(fn, reps=5)
            bms, by = bound_ms(w)
            log("timing", kernel=kernel, field=name, dims=(n, n, n), ms=ms,
                bound_ms=bms, bound_by=by, bytes=w["bytes"], ops=w["ops"],
                ops_v1=w["ops_v1"], ops_per_vertex=w["ops"] / g.nv,
                ops_v1_per_vertex=w["ops_v1"] / g.nv,
                pops_per_vertex=w["pops_per_vertex"],
                divergence=w["divergence"],
                divergence_regrouped=w["divergence_regrouped"],
                **shape[kernel], smi=smi)
            records[(kernel, name, n)] = dict(ms=ms, bound_ms=bms,
                                              bound_by=by)
        if plain and (name, n) == ("isabel", 256):
            plain_ms = cuda_ms(lambda: ref.lower_star_gradient_torch(
                nb, o, rank_bound=g.nv), reps=1)
            log("timing", kernel="plain", field=name, dims=(n, n, n),
                ms=plain_ms, smi=smi)
            records["plain_ms"] = plain_ms
        del nb, o, runs
        torch.cuda.empty_cache()
    if hasattr(LS, "fused_rows_from_halo_volume"):
        records["fused_halo"] = time_halo(isabel_256, plain, smi)
    return records


def time_halo(isabel_256, plain, smi):
    """CUDA-event times of the halo entry on every chunk of ``isabel``
    256^3 (int64 keys, ``chunk_z=32``), each beside its bound, and the
    totals over the grid (and the plain version's, if ``plain``)."""
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ops
    from repro_torch.stream import pack_value_keys_torch, plan_chunks
    g = Grid.of(256, 256, 256)
    keys = pack_value_keys_torch(torch.from_numpy(isabel_256).cuda(), 0)
    plane = g.dims[0] * g.dims[1]
    tot = dict(ms=0.0, plain_ms=0.0 if plain else None, bytes=0, ops=0)
    for c in plan_chunks(g.dims, chunk_z=32):
        ext = _chunk_ext(keys, c, g.dims)
        out = LS.fused_rows_from_halo_volume(ext)
        work = pairing_work(out[0], out[2])
        del out
        work["bytes"] = _roofline().io_bytes(c.nz * plane, 8, False,
                                             ghosts=2 * plane)
        ms = cuda_ms(lambda: LS.fused_rows_from_halo_volume(ext), reps=5)
        bms, by = bound_ms(work)
        pms = cuda_ms(lambda: ops.lower_star_rows_halo(ext, "torch"),
                      reps=1) if plain else None
        log("timing", kernel="fused_halo", field="isabel", dims=g.dims,
            chunk=(c.zlo, c.zhi), ms=ms, bound_ms=bms, bound_by=by,
            bytes=work["bytes"], ops=work["ops"], plain_ms=pms,
            pops_per_vertex=work["pops_per_vertex"],
            divergence_regrouped=work["divergence_regrouped"], smi=smi)
        tot["ms"] += ms
        tot["bytes"] += work["bytes"]
        tot["ops"] += work["ops"]
        if plain:
            tot["plain_ms"] += pms
        del ext
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot)
    log("timing", kernel="fused_halo", field="isabel", dims=g.dims,
        chunks="all", **tot, smi=smi)
    del keys
    torch.cuda.empty_cache()
    return tot


def group_only():
    """The build, [train_mesh] (with [plan]'s mesh plans held to it),
    [stream]'s multi-card part, and [dist] (with [plan]'s DDMS peak held
    to it) and [group]: on a host with two cards or more (four for
    [train_mesh]), the quickest check of the multi-card paths.  Each part runs even where one before it failed ([group] needs
    [dist]'s outputs); a failure prints its traceback and the script then
    exits 1, naming the parts that failed."""
    import traceback
    from repro_torch.fields.generators import make_field
    smi = nvidia_smi_line()
    phase_build(smi)
    failed = []

    def part(name, fn, *args):
        try:
            return fn(*args)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(name, failed=True)
            return None

    ranks = part("train_mesh", train_mesh, smi)
    if ranks is not None:
        part("plan", plan_vs_train_mesh, ranks)
    part("stream", stream_cards, smi)
    isabel = make_field("isabel", (256, 256, 256), seed=SEED)
    dist = part("dist", phase_dist, isabel)
    if dist is not None:
        part("plan", plan_vs_dist, dist[1])
        part("group", phase_group, isabel, dist[2])
    if failed:
        log("group_only", failed=failed)
        return 1
    return 0


def time_tree(root):
    """The [timing] phase alone, on the kernels of the port in ``root``
    (for instance another commit unpacked with ``git archive``)."""
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log("build", tree=root, seconds=round(time.perf_counter() - t0, 3))
    phase_timing(make_field("isabel", (256, 256, 256), seed=SEED), None,
                 plain=False)
    return 0


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke test of the "
                                 "PyTorch / CUDA port.")
    ap.add_argument("--timing-of", metavar="DIR",
                    help="only time the kernels of the port in the tree DIR "
                    "([timing] fields, no plain version, no result lines); "
                    "to compare two trees, time each in turns in one call")
    ap.add_argument("--group", action="store_true",
                    help="only build and run [train_mesh] (4 cards), "
                    "[stream]'s multi-card part, [dist] and [group] (shards "
                    "and NCCL ranks over the cards where the host has two "
                    "or more); no result lines")
    ap.add_argument("--stream-cards-child", nargs=2, metavar=("FIELD", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.timing_of or HERE)
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print(f"chip_smoke.py: no src/repro_torch in {root}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    # [train]'s restart check runs under deterministic algorithms, which
    # need cuBLAS's workspace fixed before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    if args.timing_of:
        return time_tree(root)
    if args.stream_cards_child:
        return stream_cards_child(*args.stream_cards_child)
    if args.group:
        return group_only()
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    from repro_torch.fields.generators import make_field
    isabel = make_field("isabel", (256, 256, 256), seed=SEED)
    report = phase_build(smi)
    max_err = phase_kernels()
    halo_err = phase_halo_kernels(isabel)
    launches, fields, results = phase_main(isabel)
    phase_gradient(isabel)
    halo_launches, cards_halo_launches = phase_stream(fields, results)
    dist_launches, front, local = phase_dist(isabel)
    group_launches = phase_group(isabel, local)
    del local
    phase_approx(fields, results)
    del results
    phase_serve(fields)
    phase_cpu()
    oracle_launches = phase_oracle()
    phase_lm()
    monitor_launches, train_recs = phase_train()
    plan_launches = phase_plan(train_recs, front)
    rec = phase_timing(isabel, report)
    kernels = []
    for key, src, line in (("fused", "fused.cu", 255),
                           ("prepass", "prepass.cu", 170)):
        r = rec[(key, "isabel", 256)]
        kernels.append({
            "name": f"{key}_lower_star", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/lower_star.py:{line}",
            "launches": launches[key] + dist_launches[key]
            + group_launches[key] + oracle_launches[key]
            + (monitor_launches if key == "fused" else 0),
            "max_abs_err": max_err,
            "ms": r["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    r = rec["fused_halo"]
    kernels.append({
        "name": "fused_lower_star_halo", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/lower_star.py:325",
        "launches": halo_launches + cards_halo_launches
        + dist_launches["fused_halo"]
        + group_launches["fused_halo"] + oracle_launches["fused_halo"]
        + plan_launches,
        "max_abs_err": halo_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None})
    log("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
