"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths through their public entry points: the sampled
GraphSAGE training step (``wholegraph_tpu_torch.train``) with its embedding
in device memory, the same step with the sampled GCN, GAT and RGCN, the
typed-node (hetero) step, the host-memory tier's gather (``HostEmbedding.gather``)
at ``bench_host_gather``'s shapes, the same training step with the table
and LazyAdam's m and v in pinned host memory, full-graph message
passing (``wholegraph_tpu_torch.full_graph``: SAGE, GCN and GAT over a
``FullGraph``, forward and backward), the sharded row store
(``ShardedTable.gather`` and ``.scatter``), file IO and checkpoints
(``wholegraph_tpu_torch.io``), the hot cache (``gather_with_cache``),
the examples (``wholegraph_tpu_torch.examples``), the store and the step
at world 4, the sharded full graph at world 4
(``wholegraph_tpu_torch.graph.partitioned``,
``wholegraph_tpu_torch.models.sharded_eval``), and at world 4 the sampler
over a sharded CSR, the host tier, the hot cache, the typed-node store,
the examples under the launcher and the multichip dry run. In order:

1. builds every hand-written kernel from ``wholegraph_tpu_torch/csrc``, and
   the native file reader (``csrc/fastio.cpp``) with the host compiler;
1a. ``[stamp]``: the Timeline's stamp kernel (``utils.perf.STAMP``) held
   against its plain version (``perf._stamp_plain``, a CPU Timeline): the
   same nested spans run eagerly and, captured in a CUDA graph, replayed
   twice, with rings of STAMP_CAPACITIES rows (below, between and above
   the stamps asked for); the rings' tags (span, entry or exit, host-clock
   index), the cursor and the drop count must be equal, and the card's
   clock must never run back;
2. measures the host link: the pinned->card and card->pinned rate of a
   1 GiB ``copy_`` (CUDA events), the yardstick printed beside kernels E and
   F (their bounds take the link's data-sheet peak, LINK_BYTES_PER_S), and
   the duplex rate of both at once on two streams, the yardstick of kernel
   L's host route, which reads and writes at once;
3. builds the full-width synthetic state (``SageTrainConfig()``: 2M nodes,
   dim 256, batch 1024, fanouts (10, 15)) and runs one step that records the
   arguments of every kernel wrapper call (the apply's, kernel L's, with
   copies of the table, m and v as they were before it);
4. holds kernels A, C, D and L against their plain PyTorch versions on
   exactly those tensors (plus A in bf16 and D as a sum; A and L bit for
   bit), and times kernel, plain version and one PyTorch library call
   computing the same function (A and D also by device time, each call's
   share of its bound printed; D also at ``bench_spmm``'s call). L, for
   which no library call exists, is checked in ``[sparse_apply]`` at the
   apply's calls (a)-(d) (:func:`apply_calls`: (a) the main step's own,
   ``bench_apply``'s through the dedup path, the hetero step's three typed
   calls, (a) over a bf16 table), each bit for bit and timed so beside the
   parent's route (kernel A x3, the optimizer's update and kernel B x3) by
   device time, and (b)'s whole ``apply_gradients``; each call also bit for
   bit under the registry's other optimizers (APPLY_OTHER_OPTIMIZERS). Kernel C is the
   whole sampler hop (``sample_hop_uniform``): bit-equal to its plain
   version on all five ``SampleResult`` fields on the step's two hops and on
   graphs with rows of degree 0, K and K + 1, a hub and out-of-range
   centres at K = 1, 10, 15 and 200, one kernel launched per
   ``csr_sample_neighbors`` call (its counter and torch.profiler); timed,
   also as device time from a CUDA graph, beside the parent's route (the PyTorch draw, then C's fetch ``sample_cols``), the
   plain version and the fetch's ``take`` (a reference: no single PyTorch
   call samples); C's fetch route checked on the same hops' positions;
5. runs a tiny step three times from the same numpy-made graph, table and
   weights on the card and on the CPU, with the embedding in device memory
   and in the host tier: the RNG and samples must be bit-equal, losses and
   touched rows equal within tolerance, untouched rows unchanged, and every
   cached row equal to its host row; then three tiny steps each of the
   sampled GCN (block and true degrees), GAT, RGCN and the hetero step on
   the card and on the CPU, losses within 1e-5 and the tables' summed row
   gradients (SGD) within 1e-4 of the largest;
6. the device-memory path: resets the launch counters, trains STEPS
   full-width steps, each timed on the card by a ``utils.perf.Timeline``
   (its ``step`` span and the spans of ``train.STAGES``; launch counts,
   here and in every phase, leave the Timeline's stamps out, which are
   printed beside them), fails if any of kernels A-D was not launched or the sampler
   launched anything but kernel C's hop, once a hop, and profiles
   ten more steps with ``torch.profiler`` (launches per step, busy share,
   the sample stage beside the step);
6a. ``[io]``: a second ``SageTrainConfig()`` state after IO_WARM_STEPS
   steps; its 2,000,000 x 256 f32 table (2,048,000,000 bytes) written as
   IO_PARTS part files by the native writer (``csrc/fastio.cpp``, built
   by the host compiler) and read back onto the card by
   ``Embedding.from_filelist`` through the pinned staging ring, buffered
   and with O_DIRECT, bit-equal, the rates printed beside the ``[link]``
   line's with the mode the O_DIRECT read really ran in (the native
   reader reports whether O_DIRECT opened every file); the LazyAdam state (table, m and v, 6,144,000,000 bytes)
   through ``AsyncCheckpointer`` (snapshot ms on this thread, write ms
   in the background while the next step writes the table in place),
   reloaded by ``load_embedding`` (load ms) bit-equal, and the next
   step's loss from the reloaded state bit-equal to the live one's; a
   host-tier checkpoint on the card (kernel E and L's host route) round-trips too.
   Where the disk holds less than twice the bytes, the rows are cut (the
   width stays 256) and the line says so;
6b. ``[hot_cache]``: the same state's top-degree rows at
   ``cache_ratio=0.2`` (400,000 rows, 409,600,000 bytes) as a
   ``HotCache``: ``gather_with_cache`` of a step's unique ids bit-equal to
   its plain version and to ``Embedding.gather`` (two kernel A launches),
   timed beside A on the same ids with the hit fraction; after a cached
   step (``train.train_step`` with ``state.cache``, the example's step)
   the touched lines are invalid and served from the table; then
   CACHED_STEPS cached steps (lines invalidated after each apply) against
   as many uncached ones on a copy of the state, losses bit-equal under
   PyTorch's deterministic algorithms;
7. ``[weighted]``: kernel K, the weighted sampler hop, at
   ``bench_sampling(weighted=True)``'s shape (2,000,000 rows of degrees
   16..48, 64 M edges, weights ``U[0, 1) + 0.1`` and their pair table,
   65,536 centres, K = 15): both routes (pair table, separate arrays) held
   against the plain version on the card by the equality rule of
   ``ops.sampling.weighted_near_ties`` (bit for bit on every centre without
   two keys within 4 ulps near its cut; the near-tie counts printed), the
   routes bit-equal, one K launch a ``csr_sample_neighbors`` call by its
   count and no other kernel by the profiler; timed by CUDA events and as
   device time, beside the separate route, the plain version, the bound
   and ``torch.topk`` of the ready key matrix (a reference), and split by
   the probes of ``tools/kernel_variants.py`` (each takes one step out of
   K's register path: centre rows only, keys only, no sort, the sort over
   plain weights, no neighbour shuffle) with each build's registers,
   built from this checkout and timed in turns beside K; then degrees 0,
   K, K + 1, 32, 33, 64, 65, 128, 129, 256, 257 and a hub of 2^17,
   weights 0, -1, NaN and inf and out-of-range centres at K = 1, 15 and
   200;
8. ``[weighted_train]``: the device-memory step at
   ``SageTrainConfig(sample_method="weighted")`` (the graph of step 3 plus
   its weights and pair table): one captured step whose two K calls are
   checked and timed, then WEIGHTED_STEPS timed steps with the counts from
   0, failing unless K ran twice a step and C never, with the stage split,
   peak memory and a profiled window; a tiny weighted step, card against
   CPU, runs in ``[parity]``;
9. ``[sampled_agg]``: ``padded_reduce_windowed`` at
   ``bench_spmm_sampled``'s shape (the (10, 15) sample of 1,024 sorted
   centres over ``clustered_csr(2,000,000, 16, 192)``, x [U, 256] f32, the
   bench's per-run windows, mean): one kernel D launch, bit-equal to
   ``padded_reduce``, within K f32 ulps of the plain version, its gradient
   finite; timed;
9a. ``[sampled_models]``: the device-memory step at ``SageTrainConfig()``'s
   full width for the sampled GCN with block and with true degrees
   (``with_degrees=True``), GAT (4 heads of 64, one in the last layer) and
   RGCN (2 pseudo-relations): for each, one captured step whose every A, C,
   D and L call is held against its plain version (A, C and L bit-equal, D
   within K f32 ulps; D only in GCN, A also for GAT's and RGCN's neighbour
   rows), then NEW_STEPS timed steps with the counts from 0, failing unless
   each kernel ran exactly its calls a step (L once, B never); median, p90,
   stage split, peak memory and a profiled window;
9b. ``[hetero]``: ``HeteroTrainConfig()`` (the hetero example's widths,
   counts times 250: 1,000,000 papers, 375,000 authors, 50,000
   institutions, about 20M edges of 6 relations, the store under LazyAdam),
   its numpy build timed on its own line, then as in 9a (A 5 and L 3 calls
   a step, C 2, no B or D), each A and L call's device ms (a CUDA graph of
   20 calls, :func:`graph_ms`) printed beside its bound and the library
   call's (A) or the parent route's (L) device ms, as for the main step's
   calls in 4;
9c. ``[scan_epoch]``: ``train.train_epoch`` (the scanned epoch: the
   epoch's first steps eagerly, one captured step, a CUDA graph replayed
   once a batch) at ``SageTrainConfig()``'s full width, nothing cut, for
   SAGE (uniform and weighted, SCAN_STEPS steps), GCN with dropout, GAT and
   RGCN (SCAN_MODEL_STEPS) and SAGE with the hot cache over two epochs of
   SCAN_CACHE_STEPS, the cache refilled in place between them: five
   copies of each state on the same batches and seeds, three run eagerly
   by ``train_step`` and two by ``train_epoch``, one eager and one graphed
   with PyTorch's deterministic algorithms; after a replay the graph's own
   C hops bit-equal to ``csr_sample_neighbors_plain`` on its seed (K's
   within the near-tie rule) and its unique ids the eager sample's, the
   changed table rows the eager run's bit for bit, the deterministic
   graphed run's losses, table, m, v and dense parameters within
   max(twice the eager spread, SCAN_FLOOR_REL of the largest value) of
   the deterministic eager run's, bit-equality printed, and the
   default-mode graphed run's within max(twice the largest spread of the
   default-mode eager runs, the same floor, SCAN_ATOMICS_REL of the
   largest value but for the losses); the captured step's launches (C or
   K twice, B three times, A, D in SAGE and GCN), the warm-up's launches
   and the graph's replays, each counted; the
   graphed step's ms (CUDA events over a later epoch's replays) beside the
   eager median and p90, the capture's ms, the host's ms to enqueue an
   epoch, the busy share over SCAN_PROFILED replays beside the eager
   step's (SAGE cases) and each run's peak memory above the states; C and
   K are also timed with the seed on the card beside the scalar seed (4
   and 7), and bit-equal to it;
10. the host gather: a 4,000,000 x 256 f32 pinned table behind an empty
   cache, batch 524,288, uniform ids and ids clustered in a span of
   1.25 x batch rows; kernel E bit-equal to its plain version, its rate
   against the link's, the bytes it read across the link (E's own count)
   and its sort's share, and the library routes (a CPU
   ``index_select`` into pinned staging and a copy; a span ``copy_`` and a
   take on the card);
11. the host-tier path: ``SageTrainConfig()`` with ``cache_ratio=0.25`` and
   the top-degree rows cached, the table, m and v each in a pinned, mapped
   allocation of its bytes (``ops.host_kernels.host_zeros``: the row stride
   and rounding printed, with the pinned bytes that the kernels' library
   and PyTorch's caching host allocator hold); one captured step (A on the hits, C twice, D
   twice, E on the misses, kernel L's host route once for the apply; no F,
   no B) whose apply call is replayed from the rows it touched as they were
   before it (the table's, m's, v's and the cache lines', restored in place,
   no second copy of the pinned tables): L's host route bit-equal to the
   composed route (E on the table, m and v, the update, F on each, B on the
   cache lines) and to the step's own result, under LazyAdam and the
   registry's other optimizers (APPLY_OTHER_OPTIMIZERS); both routes timed
   by device time (``measure_chain``) beside the apply's two bounds over
   the link, both directions at once and one after the other, and the
   ``[link]`` rates; E's calls
   (the step's and the composed route's, with the link bytes E read) and
   F's (by its written rows and a sample of untouched rows), A's and B's
   held against their plain versions; then HOST_COMPOSED_STEPS steps under
   a LazyAdam subclass, which takes the composed route (E 4, F 3, B 1 a
   step), and HOST_STEPS timed steps with the stage split, the cache hit
   fraction, peak device memory and pinned bytes, failing unless E and L's
   host route ran once a step, C once a hop, and F and B never;
12. ``[fg_spmm]``: kernel G at ``bench_spmm_clustered``'s shapes
   (``clustered_csr(2^20, 16, 192)``, 20,441,541 edges, x [2^20, 256] f32):
   mean, sum and weighted sum held against the plain version, each also
   bit-equal to G with staging off (``_stage=False``, every tile through
   device memory) and to itself, with G's own counts (tiles staged, bytes
   staged, tiles and edges left to device memory); the same degrees with
   uniform columns (no tile staged); then the forward plus backward of
   ``spmm_window``'s mean with G's transposed launch held against its plain
   version and dx against an ``index_add_`` scatter; times (CUDA events and
   device time from a CUDA graph) beside the bound, the plain version and
   cuSPARSE (``torch.sparse.mm``);
13. ``[fg_sddmm]``: kernel H at ``bench_sddmm_clustered``'s shapes, and on
    the same degrees with uniform columns (no tile's window fits), against
    its plain version (and against itself: two runs bit-identical), beside
    cuSPARSE ``sampled_addmm``, with H's own counts of the tiles it staged,
    the bytes it staged in shared memory and the edges it read from device
    memory;
14. ``[fg_gat]``: the GAT layer at ``bench_gat_layer``'s shapes (2^18 nodes,
    4 heads of 64 over width 256, self loop): one captured forward plus
    backward with the counts from 0, every G and H call held against its
    plain version, ``attn_src``'s gradient nonzero; forward and forward
    plus backward timed;
15. ``[fg_parity]``: tiny full-graph SAGE, GCN and GAT on the card against
    the CPU from the same numpy data;
16. ``[fg_model]``: ``FullGraphConfig()`` (the bench graph, a [2^20, 256]
    f32 device-memory embedding as the features) with a 2-layer SAGE and a
    2-layer GCN: for each, the counts from 0, ``eval_full_graph`` on
    FG_CENTERS centres, FG_STEPS timed ``full_graph_value_and_grad`` runs,
    failing unless A and G (both routes) were launched and G aggregated
    the widths the convs give it (SAGE's 256 -> 16 layer projects first:
    16 columns, as GCN's);
17. ``[store]``: the sharded row store (``ShardedTable``) at the JAX
    benches' shapes, a 4,000,000 x 256 table of random rows: with the counts
    from 0, ``gather(local_kernel="sorted")`` on ``bench_gather_sorted``'s
    ids (2^19 sorted unique ids at density 0.8; kernel I, f32 and bf16),
    ``gather`` on ``bench_gather``'s (2^19 uniform ids; kernel J) and
    ``scatter(donate=True)`` on ``bench_scatter``'s (kernel B's masked
    route), failing unless each launched; then each call held bit-equal to
    its plain version and timed beside its bound, kernel A on the same ids
    and ``index_select`` (``index_copy_`` for the scatter), with I's own
    counts (``_stats``: tiles windowed, tiles read directly, bytes read);
    I against A and ``index_select`` over densities 1.0, 0.8, 0.5, 0.2 at
    D = 256 and D = 16, by CUDA events and by device time (a CUDA graph),
    with its counts; I exact on unsorted,
    duplicated and out-of-range ids; the add against float64; a tiny table
    on the card against the CPU; ``gather_rows_window`` (one I launch) on
    the sorted ids bit-equal to its plain version, and
    ``choose_gather_kernel``'s answers, each held to the route every tile
    of I took on evenly spaced ids at that density;
18. ``[examples]``: each example module's ``main`` on the card, in this
    process, the launch counts from 0 for each run: ``convert_dataset
    --synthetic``, ``node_classification --smoke --epochs 2`` on the
    converted files (features by ``from_filelist``), ``node_classification
    --smoke --epochs 2 --model gat --cache-type local_device
    --train-embedding --full-graph-eval --save-dir``, ``node_classification
    --smoke --epochs 2 --device cuda:0 --scan-epoch`` with and without
    ``--cache-type local_device --train-embedding``, each beside the same
    run without ``--scan-epoch`` (epoch times and losses printed side by
    side), ``link_prediction`` and ``hetero_node_classification`` at
    ``--smoke --epochs 2``; each must print its contract lines and launch
    its kernels, and the GAT run's checkpoint must load;

19. ``[world]``: world 4 on the one card. Four ranks, each a process
    (``wt.parallel.multiprocess_run(4, ..., backend="gloo",
    device="cuda:0")``: NCCL refuses two ranks on one card, and the machine
    has one), after the parent computed the world-1 references: gloo's
    ``all_to_all_single`` on CUDA tensors checked; the store at
    ``SageTrainConfig()``'s width (2,000,000 x 256 f32, a quarter a rank)
    on each rank's sampled unique ids, every method (``a2a``,
    ``a2a_capped``, ``allgather``, ``ragged``, ``hierarchy`` as 2 x 2) and
    plan (equal, custom, round-robin), with ``dedup`` and the sorted
    serve, bit-equal to kernel J on a whole copy (``a2a_capped``: its drops
    zero rows and as many as ``gather_overflow``), a fully skewed batch
    exact after more than one round, the scatter's set and add equal to
    the same writes on the copy; 5 steps with the table and the dense
    parameters under SGD and 5 under LazyAdam held against the port's world-1 step on the
    concatenated 4 x 1,024 distinct centres (losses, dense parameters and
    the table's rows at 32,768 ids, within WORLD_TOL; the SGD table at
    WORLD_SGD_LR); 5 timed steps with the stage split, rounds and
    launches a rank (A, B, C, D and J on every rank, I in the store); the
    exchange gather split into bucket, ids out, serve, rows back,
    un-permute and the count of ids left, as ``ops.gather.EXCHANGE_MARK``
    hears them inside the call; one world-4 epoch (``train.train_epoch``
    of WORLD_STEPS LazyAdam steps on the example's stacked batches, each
    rank its columns by ``rank_share``) beside as many eager
    ``train_step``s on a second state from the same seed, both with
    PyTorch's deterministic algorithms: losses, each rank's table, m and v
    shards and the dense parameters bit-equal, the epoch's ms a step beside
    the eager median, its launches counted (A, B, C, D and J on every
    rank); NCCL at world 1 (one ``all_reduce``, one
    ``all_to_all_single``).
    Times there are gloo's through the host over one card;
20. ``[sharded_fg]``: the sharded full graph at world 4, four ranks on
    card 0 over gloo after the parent computed the world-1 references on
    the card (G over the whole CSR, the plain max, the models over the
    replicated ``FullGraph``). At ``FullGraphConfig()`` (the bench graph,
    [2^20, 256] f32 features, a quarter a rank under the equal plan):
    ``partition_graph`` (seconds a rank, ``halo_stats``), ``degrees``,
    ``spmm_halo``'s sum, mean and weighted sum bit-equal to world-1 G and
    its max to the plain max, the sorted serve (I) bit-equal, the halo
    gather (J, B) bit-equal to the rows, G on each rank's rectangular local
    CSR within K f32 ulps of its plain version and bit-equal unstaged, with
    its own counts; the SAGE, GCN and GAT halo evaluations (and RGCN at
    SFG_RGCN_NODES, 3 relations) within SFG_TOL of world 1, each pass
    timed (SFG_PASSES, median) and split by ``graph.partitioned.HALO_MARK``
    into the halo gather, the local aggregate and the dense work, G's
    launches a pass exact; the per-edge path at SFG_EDGE_NODES (the bench
    graph cut in nodes only: ``spmm_sharded``, ``sddmm_sharded`` and
    ``eval_full_graph_sharded`` against world-1 G, H and models), each
    call timed once; the counts from 0 on each rank, failing unless G, I,
    J and B ran on every rank's halo path and J and B on its per-edge path;
21. ``[world_tier]``: four ranks on card 0 over gloo after the parent's
    world-1 references on the card (the host tier and the hetero steps,
    the dense parameters under SGD), each part of a rank counting only the
    path's launches (the references' runs beside them uncounted): the
    sampler over ``SageTrainConfig()``'s graph with row_ptr, col, weights
    and pseudo-relations as ShardedTables (a (10, 15) sample of each
    rank's 1,024 centres, uniform bit-equal to C over the replicated graph,
    weighted hop by hop within K's near-tie rule; J's serves of 4-byte rows
    bit-equal to its plain version; a sharded row_ptr beside the whole col
    bit-equal too, C's fetch ``sample_cols`` a launch a hop, each held
    against its plain version; the sample's ms both ways; 2 SGD steps over
    either graph bit-equal, with PyTorch's deterministic algorithms); the
    host tier at ``host_cache_ratio=0.25`` (pinned shards of 3 x
    512,000,000 bytes a rank): 5 SGD steps (table and dense parameters)
    held against world 1 (WORLD_TOL), a captured LazyAdam step with every E
    and A call against its plain version and its apply call (L's host
    route) bit-equal to the composed route from the same rows, 5 timed
    steps split by stage, coherence on every rank, the apply's link bytes;
    the hot cache (the top-degree 20 % replicated on
    every rank): ``gather_with_cache`` bit-equal to the store's gather at
    ``cold_capacity_factor`` 0.5 and 0.1 (waves and rounds counted), 3
    cached steps bit-equal to uncached; ``HeteroTrainConfig()``: 3 steps
    against world 1 (WORLD_TOL; the paper rows within WT_HETERO_ROWS_TOL,
    beyond which a row left unchanged lies), timed and split, the rounds of each type's exchange with the
    off-type slots as -1 and as 0, peak memory; then ``link_prediction``,
    ``hetero_node_classification`` and ``node_classification
    --cache-type local_device --train-embedding`` at ``--smoke`` under
    the launcher at world 4 (``--device cuda:0 --backend gloo``, side by
    side), the last also with ``--scan-epoch``, whose epoch losses and
    ``[TEST]`` line must be those of the run without it, and
    ``entry.dryrun_multichip(4, backend="gloo", device="cuda:0")`` with
    its six lines;

then prints a ``kernels`` JSON line (A-L, G's forward and transposed
routes apart, B's and F's lines from the host tier's composed route with
B's masked launches beside its own, L's with its calls (a)-(d), L's host
route (``sparse_apply_host``) with the host-tier step's apply call, A-D's and L's launches over the
NEW_STEPS steps of each model of 9a and 9b; ``launches`` counts
wrapper calls, and G's and H's ``launches_per_call`` the kernels one
bench call launched, as its capture in a CUDA graph holds them, which must be G's span,
window and rows kernels and H's two; every kernel's launches in each
example run; A's entry also carries the ``[hot_cache]`` and ``[io]``
readings, and A-D, I and J each rank's launches in ``[world]``'s timed
steps, store and epoch; every
kernel each rank's launches in ``[sharded_fg]``, and G's entry its checks
on the local CSRs and that phase's readings; every kernel each rank's
launches in ``[world_tier]`` (C's fetch route its own), A, C's fetch,
E, J and L's host route their checks there, J's
entry its time on the 4-byte rows and A's the phase's readings), every
kernel its launches in ``[scan_epoch]`` as the warm-up's, the captured
step's calls and the graph's counted replays (C and K their checks in the
graph, A the phase's readings),
the card's name and power
limit, and,
as the last line, ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without CUDA it exits non-zero before printing any result.

``python3 chip_smoke.py --paired-times [part ...]`` only builds the kernels
and times them through entry points that every tree of the port with the
row store has (:func:`paired_times`; parts ``steps``, ``store``, ``sweep``,
``spmm``, ``sddmm``, ``hetero`` (the hetero step and each of its A and B
calls by device time), ``rows`` (the same for the main step's A and B
calls and ``[store]``'s masked B), ``agg`` (kernel D's calls (a)-(f) by
device time, and its backward profiled), ``apply`` (the sparse apply's row
update at its calls (a)-(d) by device time, then the eager and graphed SAGE
steps and the hetero step), ``host_apply`` (the host-tier step's whole
``apply_gradients`` by device time, then HOST_STEPS eager host-tier
steps), all by default; ``weighted``, uniform
and weighted steps in turns, only when named), so that the same function also times
another tree: run it from that tree's root as ``python3 -c "import runpy,
sys; sys.argv = ['chip_smoke.py', '--paired-times', 'store', 'spmm'];
runpy.run_path('<path of this file>', run_name='__main__')"``, which imports
that tree's package, for runs of two trees in turns on one card.
"""

import contextlib
import copy
import dataclasses
import inspect
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this smoke test needs a GPU")

import wholegraph_tpu_torch as wt  # noqa: E402
from wholegraph_tpu_torch import kernels  # noqa: E402
from wholegraph_tpu_torch.embedding import (SGD, AdaGrad, Embedding,  # noqa: E402
                                            HostEmbedding, LazyAdam, RMSProp,
                                            hot_ids_by_degree)
from wholegraph_tpu_torch.embedding import embedding as emb_mod  # noqa: E402
from wholegraph_tpu_torch.embedding import host_embedding as host_mod  # noqa: E402
from wholegraph_tpu_torch.embedding.host_embedding import bench_host_gather  # noqa: E402
from wholegraph_tpu_torch.examples.node_classification import rank_share  # noqa: E402
from wholegraph_tpu_torch.graph import GraphStructure, HeteroFeatureStore  # noqa: E402
from wholegraph_tpu_torch.models import GATConv, HomoGNN  # noqa: E402
from wholegraph_tpu_torch.ops import KERNELS  # noqa: E402
from wholegraph_tpu_torch.ops import gather as gather_mod  # noqa: E402
from wholegraph_tpu_torch.ops import gather_kernels as G  # noqa: E402
from wholegraph_tpu_torch.ops import host_kernels as H  # noqa: E402
try:  # kernel L; a tree before it, timed through --paired-times, has no such module
    from wholegraph_tpu_torch.ops import optim_kernels as OK  # noqa: E402
except ImportError:
    OK = None
from wholegraph_tpu_torch.ops import rng  # noqa: E402
from wholegraph_tpu_torch.ops import sampling as sampling_mod  # noqa: E402
from wholegraph_tpu_torch.ops import spmm_kernels as S  # noqa: E402
from wholegraph_tpu_torch.tools import kernel_variants  # noqa: E402
from wholegraph_tpu_torch.train import STAGES  # noqa: E402
from wholegraph_tpu_torch.utils import perf  # noqa: E402
from wholegraph_tpu_torch.utils.perf import measure_chain  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
LINK_BYTES_PER_S = 64e9     # H100 SXM PCIe Gen5 x16: 128 GB/s both ways (NVIDIA data sheet)
STEPS = 100                 # timed full-width steps (p90 has 10 beyond it)
HOST_STEPS = 30             # timed host-tier steps (p90 has 3 beyond it)
HOST_COMPOSED_STEPS = 3     # host-tier steps under a LazyAdam subclass (the composed route)
HOST_APPLY_ITERS = 5        # calls in each measure_chain of the host-tier apply's two routes
HOST_CACHE_RATIO = 0.25     # __graft_entry__.py's host-tier cache_ratio
FG_STEPS = 20               # timed full-graph value_and_grad runs per model (p90 has 2 beyond it)
FG_CENTERS = 1024           # centres of the full-graph evaluation and loss
STORE_ROWS = 4_000_000      # bench_gather's, bench_gather_sorted's and bench_scatter's table rows
STORE_BATCH = 1 << 19       # their batch
F32_EPS = float(np.finfo(np.float32).eps)
BF16_EPS = 2.0 ** -7
SAMPLE_FIELDS = ("neighbors", "mask", "positions", "edge_ids", "degree")


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, iters=20, warmup=3, lead=True):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, by CUDA events.
    With ``lead`` one more call is enqueued before the first
    event, so that the card is busy while the host enqueues the timed
    calls: the host's latency to its first launch (tens of microseconds
    through a ctypes wrapper) is not in the time unless the host cannot
    keep ahead of the card. ``lead=False`` times from the first call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        fn()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes, ops=0.0):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def link_bound_ms(link_bytes, hbm_bytes):
    """Least time for bytes that cross the host link at its data-sheet peak
    and bytes that stay in device memory."""
    return max(link_bytes / LINK_BYTES_PER_S, hbm_bytes / HBM_BYTES_PER_S) * 1e3, "bytes"


def link_yardsticks(t, link_bytes, delivered, copy_gbps):
    """Beside a host-row call's times: the ms its link bytes take at this
    run's ``copy_`` rate, and its delivered GB/s against the link's peak and
    against that rate."""
    t.update(copy_ms=link_bytes / (copy_gbps * 1e6), delivered_GBps=delivered / t["ms"] / 1e6)
    t.update(peak_share=t["delivered_GBps"] / (LINK_BYTES_PER_S / 1e9),
             copy_share=t["delivered_GBps"] / copy_gbps)
    return t


@contextlib.contextmanager
def capture(module, name, calls):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as the path looks it up) into ``calls``. Nothing but the
    embedding's tables is written after such a call, and the scatter
    checks work on copies of those or on their written rows."""
    fn = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def reset_launches():
    for k in KERNELS:
        k.launches = 0
        k.routes.clear()


def read_launches():
    """Launches of the paths' kernels since :func:`reset_launches`: all but
    the Timeline's stamps (``perf.STAMP.launches``), which time them."""
    return {k.name: k.launches for k in KERNELS if k is not perf.STAMP}


def free_pinned():
    """Return cached pinned blocks to the system (PyTorch's caching host
    allocator keeps freed ones); True where this PyTorch offers the call."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fn = getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()
    return fn is not None


def pinned_bytes(tensors):
    """(bytes of the distinct allocations under the tensors, the pinned
    bytes the kernels' library holds -- ``ops.host_kernels.
    host_alloc_bytes()``, the host tier's allocations -- plus the
    caching host allocator's own count -- ``allocated_bytes.current`` of
    ``torch.cuda.host_memory_stats()``, active and cached blocks at their
    rounded sizes, 0 where this PyTorch lacks that count)."""
    asked = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                 for t in tensors}.values())
    fn = getattr(torch.cuda, "host_memory_stats", None)
    cached = (fn().get("allocated_bytes.current") or 0) if fn is not None else 0
    lib = getattr(H, "host_alloc_bytes", None)  # an older tree pins through PyTorch alone
    return asked, (lib()["current"] if lib is not None else 0) + cached


# ---------------------------------------------------------------------------
# kernel checks on the main path's own tensors
# ---------------------------------------------------------------------------


def timings(case, kernel, plain, library, bound, iters=20, plain_iters=20, device=False):
    """One main-path call's times (ms, CUDA events) beside its bound; with
    ``device`` also the kernel's and the library call's device ms
    (:func:`graph_ms`), which at narrow calls CUDA events cannot give."""
    b_ms, by = bound
    t = {"case": case, "ms": cuda_ms(kernel, iters),
         "plain_ms": cuda_ms(plain, plain_iters, warmup=min(3, plain_iters)),
         "library_ms": cuda_ms(library, plain_iters, warmup=min(3, plain_iters)),
         "bound_ms": b_ms, "bound_by": by}
    if device:
        t.update(device_ms=graph_ms(kernel), library_device_ms=graph_ms(library))
        t["bound_share"] = b_ms / t["device_ms"]
    return t


def row_bound(kind, table, ids):
    """Kernel A's or B's bound for one call: each id read once; A reads
    each distinct clipped row once and writes every output row, B reads and
    writes each valid row once."""
    n, rb, m = table.shape[0], table.shape[1] * table.element_size(), ids.numel()
    if kind == "A":
        return bound_ms(ids.element_size() * m
                        + torch.unique(ids.long().clamp(0, n - 1)).numel() * rb + m * rb)
    valid = int(((ids >= 0) & (ids < n)).sum())
    return bound_ms(ids.element_size() * m + 2 * valid * rb)


def check_gather(calls):
    """Kernel A on the embedding gather and the apply's three row reads,
    bit for bit; timed by CUDA events and device time."""
    errs, times = [], []
    for i, (table, ids) in enumerate(calls):
        n = table.shape[0]
        for t in ((table, table.to(torch.bfloat16)) if i == 0 else (table,)):
            got, ref = G.gather_rows(t, ids), G.gather_rows_plain(t, ids)
            err = max_err(got, ref)
            require(bit_equal(got, ref), f"row_gather {t.dtype} differs from its plain version: "
                                         f"{err}")
            errs.append({"case": f"call{i} {str(t.dtype)[6:]}", "max_abs_err": err, "tol": 0.0})
        clipped = ids.long().clamp(0, n - 1)
        times.append(timings(
            f"call{i} [{ids.numel()}] of [{n}, {table.shape[1]}]",
            lambda: G.gather_rows(table, ids), lambda: G.gather_rows_plain(table, ids),
            lambda: torch.index_select(table, 0, clipped), row_bound("A", table, ids),
            device=True))
    return errs, times


def log_device_calls(tag, kern, times):
    """One line of A's or B's checked calls: each call's device ms, its
    share of the bound, the bound and the library call's device ms."""
    log(f"[{tag}] {kern.name} calls, device ms (bound share; bound, library device ms): "
        + "; ".join(f"{t['case']} {t['device_ms']:.5f} ({t['bound_share']:.3f}; "
                    f"{t['bound_ms']:.5f}, {t['library_device_ms']:.5f})" for t in times))


def check_scatter(calls):
    """Kernel B on the apply's write-backs, into a copy of each table, bit
    for bit; timed by CUDA events and device time."""
    errs, times = [], []
    for i, (table, ids, rows) in enumerate(calls):
        n = table.shape[0]
        a, b = table.clone(), table.clone()
        G.scatter_rows(a, ids, rows)
        G.scatter_rows_plain(b, ids, rows)
        err = max_err(a, b)
        require(bit_equal(a, b), f"row_scatter differs from its plain version: {err}")
        errs.append({"case": f"call{i}", "max_abs_err": err, "tol": 0.0})
        valid = (ids >= 0) & (ids < n)
        vids, vrows = ids[valid].long(), rows[valid]
        times.append(timings(
            f"call{i} [{ids.numel()}] into [{n}, {table.shape[1]}]",
            lambda: G.scatter_rows(a, ids, rows), lambda: G.scatter_rows_plain(a, ids, rows),
            lambda: a.index_copy_(0, vids, vrows), row_bound("B", table, ids), device=True))
        times[-1]["valid_rows"] = vids.numel()
        del a, b
    return errs, times


@contextlib.contextmanager
def capture_apply(calls):
    """Record every ``apply_rows`` call of the embedding's apply (kernel L's
    wrapper as ``Embedding._step_rows`` looks it up) into ``calls``, with
    copies of its table and slots as they were before it, so that a check
    replays the call from the same state."""
    fn = emb_mod.apply_rows

    def rec(table, slots, ids, grads, optimizer, step, lr):
        calls.append({"table": table.clone(), "slots": {k: v.clone() for k, v in slots.items()},
                      "ids": ids, "grads": grads, "optimizer": optimizer, "step": step,
                      "lr": lr})
        return fn(table, slots, ids, grads, optimizer, step, lr)

    emb_mod.apply_rows = rec
    try:
        yield calls
    finally:
        emb_mod.apply_rows = fn


def as_apply_call(emb, args, case=None):
    """A recorded ``_step_rows(uids, ugrads, lr, step)`` of a world-1
    embedding as an ``apply_rows`` call on its table and slots."""
    uids, ugrads, lr, step = args
    return {"table": emb.table, "slots": emb.slots, "ids": uids, "grads": ugrads,
            "optimizer": emb.optimizer, "step": step, "lr": lr, "case": case}


def apply_call_bound(c):
    """Kernel L's bound for one call: each id read once; each valid row's
    gradient read once, its table row and each slot's row read and written
    once."""
    t, ids, g = c["table"], c["ids"], c["grads"]
    valid = int(((ids >= 0) & (ids < t.shape[0])).sum())
    row = (g.element_size() + 2 * t.element_size() + 8 * len(c["slots"])) * t.shape[1]
    return bound_ms(ids.numel() * ids.element_size() + valid * row), valid


# the registry's other optimizer settings, each held bit for bit at the apply's calls (a)-(d);
# their state rows are copies of the call's LazyAdam rows (v, non-negative, for v and state_sum)
APPLY_OTHER_OPTIMIZERS = (SGD(weight_decay=0.01), LazyAdam(weight_decay=0.01, adam_w=True),
                          RMSProp(weight_decay=0.01), AdaGrad(weight_decay=0.01))


def apply_bits(c, case):
    """Kernel L and its plain version on their own copies of a call's table
    and slots: fails unless bit-equal; returns the check's line."""
    args = (c["ids"], c["grads"], c["optimizer"], c["step"], c["lr"])
    ta, sa = c["table"].clone(), {k: v.clone() for k, v in c["slots"].items()}
    tb, sb = c["table"].clone(), {k: v.clone() for k, v in c["slots"].items()}
    OK.apply_rows(ta, sa, *args)
    OK.apply_rows_plain(tb, sb, *args)
    err = max([max_err(ta, tb)] + [max_err(sa[k], sb[k]) for k in sa])
    require(bit_equal(ta, tb) and all(bit_equal(sa[k], sb[k]) for k in sa),
            f"sparse_apply differs from its plain version ({case}): {err}")
    return {"case": case, "max_abs_err": err, "tol": 0.0}


def check_apply(calls):
    """Kernel L on each call (``apply_rows``'s arguments, the table and
    slots as before it), bit for bit against its plain version, each on its
    own copy of the table and slots; timed by CUDA events and device time
    (:func:`graph_ms`) beside the bound, the plain version and the parent's
    route (kernel A on the table and each slot, the optimizer's ``update``,
    kernel B on each) by device time. Launches made here are outside every
    counted run."""
    errs, times = [], []
    for i, c in enumerate(calls):
        args = (c["ids"], c["grads"], c["optimizer"], c["step"], c["lr"])
        (b_ms, by), valid = apply_call_bound(c)
        case = c.get("case") or f"call{i}"
        case += (f" [{c['ids'].numel()}] ({valid} valid) into {list(c['table'].shape)} "
                 f"{str(c['table'].dtype)[6:]}, grads {str(c['grads'].dtype)[6:]}, "
                 f"{c['optimizer'].name}")
        errs.append(apply_bits(c, case))
        ta, sa = c["table"].clone(), {k: v.clone() for k, v in c["slots"].items()}

        def kern():
            OK.apply_rows(ta, sa, *args)

        t = {"case": case, "valid": valid, "ms": cuda_ms(kern), "device_ms": graph_ms(kern),
             "plain_ms": cuda_ms(lambda: OK.apply_rows_plain(ta, sa, *args), 5, warmup=1),
             "parent_route_device_ms": graph_ms(
                 lambda: OK._composed(G.gather_rows, G.scatter_rows, ta, sa, *args)),
             "library_ms": None, "bound_ms": b_ms, "bound_by": by}
        t["bound_share"] = b_ms / t["device_ms"]
        times.append(t)
        del ta, sa
    torch.cuda.empty_cache()
    return errs, times


def log_apply_calls(tag, times):
    """One line of L's checked calls: each call's device ms, its share of
    the bound, the bound, the plain version's ms and the parent route's
    device ms."""
    log(f"[{tag}] sparse_apply calls, device ms (bound share; bound, plain ms, parent route "
        f"device ms): " + "; ".join(
            f"{t['case']} {t['device_ms']:.5f} ({t['bound_share']:.3f}; {t['bound_ms']:.5f}, "
            f"{t['plain_ms']:.4f}, {t['parent_route_device_ms']:.5f})" for t in times))


def check_sparse_apply(main_call, gen):
    """``[sparse_apply]``: kernel L at the apply's calls (a)-(d) (:func:`
    apply_calls`): (a) the main step's own call as ``[capture]`` recorded
    it, (b) ``bench_apply``'s, (c) the hetero step's three typed calls, (d)
    (a) over a bf16 copy of the table; each through :func:`check_apply`,
    and (b)'s whole ``apply_gradients`` by device time."""
    c16 = dict(main_call, table=main_call["table"].to(torch.bfloat16),
               slots={k: v.clone() for k, v in main_call["slots"].items()}, case="(d)")
    calls = apply_calls(gen, "bc")
    cases = ([dict(main_call, case="(a)")]
             + [as_apply_call(v["emb"], v["args"], f"({k})") for k, v in calls.items()] + [c16])
    errs, times = check_apply(cases)
    times[1]["whole_device_ms"] = graph_ms(calls["b"]["whole"])
    log_apply_calls("sparse_apply", times)
    log(f"[sparse_apply] (b) the whole apply_gradients (dedup and L): "
        f"{times[1]['whole_device_ms']:.5f} device ms")
    for opt in APPLY_OTHER_OPTIMIZERS:  # the registry's other settings, at the same calls
        for c in cases:
            slots = {n: c["slots"]["m" if n == "m" else "v"] for n in opt.slot_names}
            errs.append(apply_bits(dict(c, optimizer=opt, slots=slots),
                                   f"{c['case']} {opt.name}"
                                   + (" adam_w" if getattr(opt, "adam_w", False) else "")
                                   + f", weight decay {opt.weight_decay}"))
    log(f"[sparse_apply] {len(errs)} calls bit-equal to the plain route: (a)-(d) under "
        f"LazyAdam, SGD, LazyAdam with adam_w, RMSProp and AdaGrad, each with weight decay "
        f"but the first, {str(main_call['table'].dtype)[6:]} and bf16 tables")
    del calls, c16, cases
    torch.cuda.empty_cache()
    return errs, times


def same_sample(a, b):
    """All five fields of two SampleResults bit-equal (dtypes included)."""
    return all(getattr(a, f).dtype == getattr(b, f).dtype and torch.equal(getattr(a, f), getattr(b, f))
               for f in SAMPLE_FIELDS)


def parent_route(row_ptr, col, centers, K, seed, hop):
    """The parent's hop: the draw and the rank fixpoint as PyTorch ops, then
    the separate column fetch (C's ``wg_sample_cols``)."""
    start, deg = sampling_mod._centre_rows(row_ptr, centers)
    pos, mask = sampling_mod._sample_positions_uniform(deg, K, seed, centers, hop)
    return G.sample_cols(col, start, pos, mask), mask, pos, start[:, None] + pos, deg


def profiled(fn, iters=1):
    """By torch.profiler over ``iters`` calls of ``fn()`` (copies and memsets
    not counted): the kernel launches it recorded per call, and their
    names. On an H100 the profiler missed launches of some windows (19 of
    20 recorded, 2 of 20, none of 1), so a count it gives is a lower bound
    and times come from :func:`graph_ms`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
            and not e.key.startswith(("Memcpy", "Memset"))]
    return sum(e.count for e in kern) / iters, [e.key[:60] for e in kern]


G_KERNELS = ("csr_spmm_span_kernel", "csr_spmm_window_kernel", "csr_spmm_rows_kernel")
H_KERNELS = ("csr_sddmm_device_kernel", "csr_sddmm_window_kernel")


def graph_kernels(fn):
    """The kernel launches of one call of ``fn()``, by (mangled) name: the
    call captured in a CUDA graph, whose kernel nodes are read back through
    the driver API (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``,
    ``cuFuncGetName``). A capture records every launch of the call, where
    torch.profiler on an H100 missed some (one kernel of a two-kernel call
    over 25 calls in a row, or every kernel of up to 12 windows of 5)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        require(rc == 0, f"{name} returned CUresult {rc}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = vp(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: CUfunction func at 0, CUkernel kern at 56
        params = (ctypes.c_uint8 * 128)()
        call("cuGraphKernelNodeGetParams_v2", vp(node), params)
        func = vp.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            call("cuFuncGetName", ctypes.byref(name), vp(func))
        else:
            call("cuKernelGetName", ctypes.byref(name), vp(vp.from_buffer(params, 56).value))
        names.append(name.value.decode())
    graph.reset()
    return names


def launch_structure(case, fn, expect):
    """The kernels one call of ``fn()`` launches (:func:`graph_kernels`).
    Fails unless they are exactly the kernels of ``expect`` (one name for
    each kernel the wrapper should launch), each launched once. Returns
    their number, the launches and each one's identifier out of its mangled
    name."""
    names = graph_kernels(fn)
    require(sorted(sum(x in k for k in names) for x in expect) == [1] * len(expect)
            and all(any(x in k for x in expect) for k in names),
            f"{case}: one call launched the kernels {names}, expected {list(expect)} once each")
    return {"kernels_per_call": len(set(names)), "launches_per_call": len(names),
            "kernels_seen": sorted((re.search(r"[a-z_]+_kernel", k) or re.search(".{,60}", k))[0]
                                   for k in names)}


def graph_ms(fn, iters=20):
    """Device ms of one call of ``fn()``: ``utils.perf.measure_chain``'s
    capture of ``iters`` calls in a CUDA graph (and of one, differenced
    out), the graphs replayed and timed by CUDA events. The graph launches
    the calls' kernels back to back, so none of the host's per-call work
    (checks, allocations, the launch itself) is in the time, where at
    D = 16 it is most of what :func:`cuda_ms` reads."""
    return measure_chain(lambda i: fn(), iters, device="cuda") * 1e3


def sampler_cases(gen):
    """Graphs and centres beyond the step's: rows of degree 0, K and K + 1,
    a hub of degree 10^6, every centre id outside [0, n) of either sign."""
    out = []
    for K in (1, 10, 15, 200):
        n = 20_000
        degs = torch.randint(0, 2 * K + 4, (n,), generator=gen, device="cuda")
        degs[:6] = torch.tensor([0, 0, 0, K, K + 1, 1_000_000], device="cuda")
        row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                             torch.cumsum(degs, 0)]).to(torch.int32)
        col = torch.randint(0, n, (int(row_ptr[-1]),), generator=gen, device="cuda",
                            dtype=torch.int32)
        centers = torch.cat([torch.arange(n, device="cuda"),
                             torch.tensor([5, 5, 3, 4, 0, -1, -7, n, n + 9, -(2**31), 2**31 - 1],
                                          device="cuda")]).to(torch.int32)
        out.append((f"K={K} degrees 0, K, K+1, hub 10^6, out-of-range centres",
                    (row_ptr, col, centers, K, 17, 1)))
    return out


def check_sample_hop(calls, gen):
    """Kernel C on each hop of the step, and on :func:`sampler_cases`: the
    hop kernel bit-equal to its plain version on all five fields, and one
    kernel launch per hop; C's fetch route on the same hops' positions.
    Times per hop: the kernel (CUDA events, and its device time by
    :func:`graph_ms`), the parent's route (the PyTorch draw then the fetch), the
    plain version, and the fetch's ``take`` with its index and mask inside
    the timed call (a reference: no single PyTorch call samples)."""
    errs, times = [], []
    cases = [(f"hop{i} B={c[2].numel()} K={c[3]}", c) for i, c in enumerate(calls)]
    for case, (row_ptr, col, centers, K, seed, hop) in cases + sampler_cases(gen):
        got = sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)
        ref = sampling_mod.csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)
        require(same_sample(got, ref), f"sample_hop_uniform ({case}) differs from its plain version")
        require(same_sample(got, sampling_mod.SampleResult(*parent_route(
            row_ptr, col, centers, K, seed, hop))), f"the parent's route differs ({case})")

        def call():
            return wt.ops.csr_sample_neighbors(row_ptr, col, centers, K, seed=seed, hop=hop)

        k0 = sampling_mod.SAMPLE_HOP.launches
        call()
        require(sampling_mod.SAMPLE_HOP.launches == k0 + 1,
                f"csr_sample_neighbors ({case}) did not launch kernel C once")
        for _ in range(3):  # a window in which the profiler recorded something
            n_kern, names = profiled(call, 5)
            if names:
                break
        require(names and n_kern <= 1 and all("hop_" in k for k in names),
                f"csr_sample_neighbors ({case}) launched other kernels: {n_kern} a call, {names}")
        dev_ms = graph_ms(call)
        seed_t = torch.tensor(seed, dtype=torch.int64, device="cuda")
        require(same_sample(sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed_t, hop),
                            got), f"sample_hop_uniform ({case}) with the seed on the card differs")
        valid = int(ref.mask.sum())
        errs.append({"case": case, "max_abs_err": 0.0, "tol": 0.0, "fields": list(SAMPLE_FIELDS),
                     "valid_slots": valid, "kernels_per_call": n_kern})
        # C's fetch route, on the same positions
        start, _ = sampling_mod._centre_rows(row_ptr, centers)
        fetch = G.sample_cols(col, start, ref.positions, ref.mask)
        require(torch.equal(fetch, G.sample_cols_plain(col, start, ref.positions, ref.mask)),
                f"sample_cols ({case}) differs from its plain version")
        if not case.startswith("hop"):
            continue
        B = centers.numel()
        pos, mask, n_e = ref.positions, ref.mask, col.shape[0]

        def take():  # the fetch alone, index and mask in the call
            e = (start.long()[:, None] + pos.long()).clamp(0, n_e - 1)
            return torch.where(mask, torch.take(col, e), -1)

        nbytes = B * (4 + 8 + 4) + 4 * valid + B * K * 13
        b_ms, by = bound_ms(nbytes)
        t = {"case": f"{case.split()[0]} [{B}, {K}]", "ms": cuda_ms(
                lambda: sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)),
             "parent_route_ms": cuda_ms(lambda: parent_route(row_ptr, col, centers, K, seed, hop),
                                        10),
             "plain_ms": cuda_ms(lambda: sampling_mod.csr_sample_neighbors_plain(
                 row_ptr, col, centers, K, seed, hop), 10),
             "device_ms": dev_ms,
             # the entry train_epoch's graph launches: the seed read on the card
             "device_seed_ms": cuda_ms(lambda: sampling_mod.sample_hop_uniform(
                 row_ptr, col, centers, K, seed_t, hop)),
             "device_seed_device_ms": graph_ms(lambda: sampling_mod.sample_hop_uniform(
                 row_ptr, col, centers, K, seed_t, hop)),
             "library_ms": None, "take_ms": cuda_ms(take), "bound_ms": b_ms,
             "bound_by": by,
             "bytes": nbytes, "valid_slots": valid,
             "fetch_route": {"ms": cuda_ms(lambda: G.sample_cols(col, start, pos, mask)),
                             "plain_ms": cuda_ms(lambda: G.sample_cols_plain(col, start, pos,
                                                                             mask)),
                             "bound_ms": bound_ms(4 * B + 9 * B * K + 4 * valid)[0]}}
        t["bound_share"] = t["bound_ms"] / t["ms"]
        times.append(t)
        log(f"[check] sample_hop_uniform {t['case']}: kernel {t['ms']} ms (CUDA events over "
            f"back-to-back calls; its device time {dev_ms} ms, from a CUDA graph; with the seed "
            f"on the card {t['device_seed_ms']} ms, device {t['device_seed_device_ms']} ms), "
            f"parent's route "
            f"{t['parent_route_ms']} ms, plain {t['plain_ms']} ms, fetch take {t['take_ms']} ms "
            f"(reference), bound {b_ms} ms; fetch route sample_cols {t['fetch_route']['ms']} ms")
    return errs, times


def agg_bound(x, nbr, mask):
    """Kernel D's bound for one call: the ids and mask read once (5 bytes a
    slot), each distinct valid neighbour row read once and each output row
    written once; one f32 add a valid slot and column."""
    B, K = nbr.shape
    rb = x.shape[1] * x.element_size()
    uniq = torch.unique(nbr[mask].long().clamp(0, x.shape[0] - 1)).numel()
    return bound_ms(5 * B * K + uniq * rb + B * rb, int(mask.sum()) * x.shape[1])


def agg_tol(ref, K, dtype):
    """D against its plain version: both add up to K f32 values, in other
    orders, so K f32 ulps of the largest output; in bf16 both round the f32
    sum, one bf16 ulp apart at most."""
    scale = max(1.0, ref.float().abs().max().item())
    return K * F32_EPS * scale + (BF16_EPS * scale if dtype == torch.bfloat16 else 0.0)


def agg_library(x, nbr, mask, mean):
    """``embedding_bag`` of the same function: the masked slots weigh 0,
    the mean's valid ones 1 / count."""
    w = mask.to(x.dtype)
    if mean:
        w = w / w.sum(dim=1, keepdim=True).clamp(min=1.0)
    idx = nbr.long().clamp(0, x.shape[0] - 1)
    return lambda: F.embedding_bag(idx, x, mode="sum", per_sample_weights=w)


def check_neighbor_agg(calls):
    """Kernel D on each call, as made and as the other of sum and mean, in
    f32 and bf16, within :func:`agg_tol`; each call timed by CUDA events
    and by device time beside its bound, its plain version and
    ``embedding_bag``."""
    errs, times = [], []
    for i, (x, nbr, mask, mean) in enumerate(calls):
        B, K = nbr.shape
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            for m in (mean, not mean):
                ref = S.neighbor_reduce_plain(xd, nbr, mask, m)
                tol = agg_tol(ref, K, dt)
                err = max_err(S.neighbor_reduce(xd, nbr, mask, m), ref)
                require(err <= tol, f"neighbor_agg {dt} mean={m} err {err} > tol {tol}")
                errs.append({"case": f"layer{i} {str(dt)[6:]} {'mean' if m else 'sum'}",
                             "max_abs_err": err, "tol": tol})
        times.append(timings(
            f"layer{i} [{B}, {K}] over [{x.shape[0]}, {x.shape[1]}]",
            lambda: S.neighbor_reduce(x, nbr, mask, mean),
            lambda: S.neighbor_reduce_plain(x, nbr, mask, mean),
            agg_library(x, nbr, mask, mean), agg_bound(x, nbr, mask), device=True))
        times[-1]["plain_device_ms"] = graph_ms(lambda: S.neighbor_reduce_plain(x, nbr, mask, mean))
    return errs, times


AGG_BENCH = (1 << 17, 1 << 16, 16)  # bench_spmm's rows, centres and K (bench.py:375)


def agg_bench_call(gen):
    """``bench_spmm``'s call: [2^16, 16] uniform ids over x [2^17, 256] f32
    (random here, ones there), every slot valid, mean."""
    n, B, K = AGG_BENCH
    x = torch.randn(n, 256, generator=gen, device="cuda")
    nbr = torch.randint(0, n, (B, K), generator=gen, device="cuda", dtype=torch.int32)
    return x, nbr, torch.ones(B, K, dtype=torch.bool, device="cuda"), True


def agg_calls(gen):
    """Kernel D's calls (a)-(f), ``{name: (x, nbr, mask, mean)}``: (a) and
    (b) the SAGE step's two layers at ``SageTrainConfig()``, (c) the
    sampled GCN's last layer (16-wide rows), (d) ``bench_spmm_sampled``'s
    block, (e) ``bench_spmm``'s, (f) call (a) in bf16. Through entry points
    every tree of the port has."""
    cfg = wt.SageTrainConfig()
    out = {}
    for tag, kw in (("sage", {}), ("gcn", {"model_type": "gcn", "degree_mode": "block"})):
        st = wt.build_synthetic(dataclasses.replace(cfg, **kw), device="cuda", seed=0)
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device="cuda",
                          dtype=torch.int32)
        d = captured_step(wt.train_step, st, c, st.labels[c.long()])[0]["D"]
        if tag == "sage":
            out["a"], out["b"] = d
            backward = agg_backward(st, c, st.labels[c.long()], d)
        else:
            out["c"] = next(call for call in d if call[0].shape[1] == cfg.num_classes)
        del st, d
        torch.cuda.empty_cache()
    x, nbr, msk = sampled_agg_block()[:3]
    out["d"] = (x, nbr, msk, True)
    out["e"] = agg_bench_call(gen)
    x, nbr, msk, mean = out["a"]
    out["f"] = (x.to(torch.bfloat16), nbr, msk, mean)
    return out, backward


def agg_backward(st, c, y, calls, steps=5):
    """D's backward (``NeighborReduce.backward``: the [B·K, D] f32 ``edges``
    tensor, then ``index_add_``) on the SAGE step: the device ms a step that
    ``torch.profiler`` gives its autograd node over ``steps`` steps (beside
    the step's device ms of every kernel), and its device time alone at
    each of the step's calls (:func:`graph_ms`, a random cotangent)."""
    from torch.profiler import ProfilerActivity, profile

    wt.train_step(st, c, y, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            wt.train_step(st, c, y, seed=0)
        torch.cuda.synchronize()

    def dev(e):  # microseconds; cuda_time_total before device_time_total
        return e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total

    out = {"profiled_ms_a_step": {e.key: dev(e) / steps / 1e3 for e in prof.key_averages()
                                  if "NeighborReduceBackward" in e.key},
           "step_kernels_ms": sum(dev(e) for e in prof.key_averages()
                                  if e.device_type == torch.autograd.DeviceType.CUDA)
           / steps / 1e3, "calls": []}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for x, nbr, mask, mean in calls:
        ctx = type("Ctx", (), {"saved_tensors": (nbr, mask), "mean": mean, "x_shape": x.shape})
        ct = torch.randn(nbr.shape[0], x.shape[1], generator=gen, device="cuda")
        out["calls"].append({"shape": [nbr.shape[0], nbr.shape[1], x.shape[1]],
                             "device_ms": graph_ms(lambda: S.NeighborReduce.backward(ctx, ct)),
                             "edges_bytes": nbr.numel() * x.shape[1] * 4})
    log(f"[agg] D's backward: profiled {out['profiled_ms_a_step']} ms a step (the step's kernels "
        f"{out['step_kernels_ms']:.4f} ms); alone, device ms by call "
        f"{[round(t['device_ms'], 5) for t in out['calls']]}")
    return out


def agg_times(calls, rounds=3):
    """Each of :func:`agg_calls` held to its plain version (:func:`agg_tol`)
    and timed by device time (:func:`graph_ms`), the calls in turns over
    ``rounds`` rounds (median and spread), beside the bound and the device
    times of the plain version and ``embedding_bag``; with D's plan where
    the tree has one."""
    out = {}
    plan = getattr(S, "agg_plan", None)
    for name, (x, nbr, mask, mean) in calls.items():
        ref = S.neighbor_reduce_plain(x, nbr, mask, mean)
        err = max_err(S.neighbor_reduce(x, nbr, mask, mean), ref)
        tol = agg_tol(ref, nbr.shape[1], x.dtype)
        require(err <= tol, f"[paired] D call ({name}) err {err} > tol {tol}")
        b_ms, by = agg_bound(x, nbr, mask)
        out[name] = {"case": f"[{nbr.shape[0]}, {nbr.shape[1]}] over [{x.shape[0]}, "
                             f"{x.shape[1]}] {str(x.dtype)[6:]} {'mean' if mean else 'sum'}",
                     "valid": int(mask.sum()), "max_abs_err": err, "tol": tol,
                     "bound_ms": b_ms, "bound_by": by, "device_rounds": [],
                     "library_device_ms": graph_ms(agg_library(x, nbr, mask, mean)),
                     "plain_device_ms": graph_ms(
                         lambda: S.neighbor_reduce_plain(x, nbr, mask, mean))}
        if plan is not None:
            rb = x.shape[1] * x.element_size()
            out[name]["plan"] = plan(nbr.shape[1], rb, G.vector_bytes(rb, x.data_ptr()))
    for _ in range(rounds):
        for name, (x, nbr, mask, mean) in calls.items():
            out[name]["device_rounds"].append(graph_ms(
                lambda: S.neighbor_reduce(x, nbr, mask, mean)))
    for t in out.values():
        t["device_ms"] = statistics.median(t["device_rounds"])
        t["spread"] = max(t["device_rounds"]) - min(t["device_rounds"])
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
    log("[agg] D calls, device ms (bound share; bound, embedding_bag device ms): "
        + "; ".join(f"({k}) {t['case']} {t['device_ms']:.5f} ({t['bound_share']:.3f}; "
                    f"{t['bound_ms']:.5f}, {t['library_device_ms']:.5f})" for k, t in out.items()))
    return out


APPLY_BENCH = (1_000_000, 256, 1 << 17)  # bench_apply's rows, width and ids (bench.py:266-310)
APPLY_LR = 0.01                          # its rate


@contextlib.contextmanager
def recording_step_rows(embs, calls):
    """Record every ``Embedding._step_rows(uids, ugrads, lr, step)`` call of
    the embeddings ``embs`` into ``calls`` as ``(emb, uids, ugrads, lr,
    step)``: the sparse apply's row update as each tree of the port runs it
    (kernel L, or kernel A x3, the optimizer's elementwise update and kernel
    B x3)."""
    for e in embs:
        def rec(uids, ugrads, lr, step, _e=e, _fn=e._step_rows):
            calls.append((_e, uids, ugrads, lr, step))
            return _fn(uids, ugrads, lr, step)

        e._step_rows = rec
    try:
        yield calls
    finally:
        for e in embs:
            del e._step_rows


def apply_calls(gen, parts="abcd"):
    """The sparse apply's calls (a)-(d) as ``_step_rows`` receives them,
    ``{name: {"emb", "args", "whole"}}``: (a) the SAGE step's apply at
    ``SageTrainConfig()`` (the step's unique ids and mask, LazyAdam, a
    2,000,000 x 256 f32 table), (b) ``bench_apply``'s (2^17 seeded uniform
    ids into 1,000,000 x 256 f32, LazyAdam, through the dedup path; its
    ``whole`` is the whole ``apply_gradients``), (c) the hetero step's three
    typed calls at ``HeteroTrainConfig()`` (``c192``, ``c128``, ``c64`` by
    row bytes), (d) call (a) over a bf16 copy of the table and copies of its
    m and v; those of ``parts``. Through entry points every tree of the port
    has."""
    cfg, dev = wt.SageTrainConfig(), torch.device("cuda")
    out = {}
    if "a" in parts or "d" in parts:
        st = wt.build_synthetic(cfg, device=dev, seed=0)
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                          dtype=torch.int32)
        rec = []
        with recording_step_rows([st.embedding], rec):
            wt.train_step(st, c, st.labels[c.long()], seed=0)
        require(len(rec) == 1, f"[apply] the SAGE step made {len(rec)} _step_rows calls")
        emb = st.embedding
        out["a"] = {"emb": emb, "args": rec[0][1:], "whole": None}
        out["d"] = {"emb": bf16_copy(emb), "args": rec[0][1:], "whole": None}
        del st, rec
    if "b" in parts:
        n, dim, batch = APPLY_BENCH
        eb = Embedding.create(n, dim, optimizer=LazyAdam(), device=dev)
        eb.init(torch.Generator(device=dev).manual_seed(0))
        ids = torch.randint(0, n, (batch,), generator=gen, device=dev)
        grads = torch.ones(batch, dim, device=dev)
        rec = []
        with recording_step_rows([eb], rec):
            eb.apply_gradients(ids, grads, APPLY_LR)
        out["b"] = {"emb": eb, "args": rec[0][1:],
                    "whole": lambda: eb.apply_gradients(ids, grads, APPLY_LR)}
    if "c" in parts:
        hcfg = wt.HeteroTrainConfig()
        hst = wt.build_hetero(hcfg, device=dev, seed=0)
        hc = hst.train_ids[torch.randperm(hst.train_ids.numel(), generator=gen,
                                          device=dev)[:hcfg.batch]]
        rec = []
        with recording_step_rows(list(hst.store.embeddings.values()), rec):
            wt.hetero_train_step(hst, hc, hst.labels[hc.long()], seed=0)
        require(len(rec) == 3, f"[apply] the hetero step made {len(rec)} _step_rows calls")
        for e, *args in rec:
            out[f"c{e.dim * e.table.element_size()}"] = {"emb": e, "args": tuple(args),
                                                         "whole": None}
        del hst
    torch.cuda.empty_cache()
    return {k: v for k, v in out.items() if k[0] in parts}


def bf16_copy(emb):
    """A world-1 embedding with a bf16 copy of ``emb``'s table and copies of
    its optimizer slots."""
    return Embedding(emb.n, emb.dim, emb.optimizer, torch.bfloat16, emb.table.device,
                     table=emb.table.to(torch.bfloat16),
                     slots={k: v.clone() for k, v in emb.slots.items()})


def apply_times(calls, rounds=3):
    """Each of :func:`apply_calls` timed by device time (:func:`graph_ms`),
    ``_step_rows`` as the tree runs it, the calls in turns over ``rounds``
    rounds (median and spread), beside the bound; (b) also the whole
    ``apply_gradients``. The calls update their tables in place."""
    out = {}
    for name, c in calls.items():
        emb, (uids, ugrads, _, _) = c["emb"], c["args"]
        (b_ms, by), valid = apply_call_bound(as_apply_call(emb, c["args"]))
        out[name] = {"case": f"[{uids.numel()}] ({valid} valid) into [{emb.table.shape[0]}, "
                             f"{emb.dim}] {str(emb.table.dtype)[6:]}, grads "
                             f"{str(ugrads.dtype)[6:]}, {emb.optimizer.name}",
                     "valid": valid, "bound_ms": b_ms, "bound_by": by,
                     "device_rounds": [], "whole_rounds": []}
    for _ in range(rounds):
        for name, c in calls.items():
            emb, args = c["emb"], c["args"]
            out[name]["device_rounds"].append(graph_ms(lambda: emb._step_rows(*args), 10))
            if c["whole"] is not None:
                out[name]["whole_rounds"].append(graph_ms(c["whole"], 10))
    for t in out.values():
        t["device_ms"] = statistics.median(t["device_rounds"])
        t["spread"] = max(t["device_rounds"]) - min(t["device_rounds"])
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        if t["whole_rounds"]:
            t["whole_device_ms"] = statistics.median(t["whole_rounds"])
        else:
            del t["whole_rounds"]
    log("[apply] _step_rows calls, device ms (bound share; bound, valid rows): "
        + "; ".join(f"({k}) {t['case']} {t['device_ms']:.5f} ({t['bound_share']:.3f}; "
                    f"{t['bound_ms']:.5f}, {t['valid']})"
                    + (f", whole apply_gradients {t['whole_device_ms']:.5f}"
                       if "whole_device_ms" in t else "") for k, t in out.items()))
    return out


def graphed_epoch_ms(cfg, gen, steps):
    """ms a step of ``train.train_epoch`` at ``cfg`` (a capturable dense
    Adam): one epoch of ``steps`` captures the step, a second of the same
    batches replays all of it and is timed by CUDA events; with its peak
    memory."""
    st = wt.build_synthetic(cfg, device="cuda", seed=0)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr, capturable=True)
    cs = torch.randint(0, cfg.n_nodes, (steps, cfg.batch), generator=gen, device="cuda",
                       dtype=torch.int32)
    ys, seeds = st.labels[cs.long()], torch.arange(steps)
    wt.train.train_epoch(st, cs, ys, seeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    losses = wt.train.train_epoch(st, cs, ys, seeds)
    t1.record()
    t1.synchronize()
    require(bool(torch.isfinite(losses).all()), f"[apply] graphed losses {losses}")
    out = {"graphed_step_ms": t0.elapsed_time(t1) / steps,
           "graphed_peak_bytes": torch.cuda.max_memory_allocated()}
    del st
    torch.cuda.empty_cache()
    return out


def time_host_gather(case, table, slots, link, kw=None):
    """Kernel E on one call (``host_gather_rows(table, slots, **kw)``, the
    sort of its plan included): times beside its bound at the link's peak
    and the measured ``copy_`` rate, the bytes E moves across the link (each
    distinct valid row once), the plan's sort alone, and the library route a
    caller without E would take: a CPU ``index_select`` of the valid rows
    into pinned staging, then a non-blocking copy to the card (the ids sit
    on the CPU beforehand)."""
    kw = kw or {}
    rb = table.shape[1] * table.element_size()
    valid = (slots >= 0) & (slots < table.shape[0])
    vids = slots[valid].long().cpu()
    staging = H.pinned_empty((vids.numel(), table.shape[1]), table.dtype)
    dst = torch.empty((vids.numel(), table.shape[1]), dtype=table.dtype, device=slots.device)

    def library():
        torch.index_select(table, 0, vids, out=staging)
        dst.copy_(staging, non_blocking=True)

    uniq = torch.unique(vids).numel()
    t = timings(case, lambda: H.host_gather_rows(table, slots, **kw),
                lambda: H.host_gather_rows_plain(table, slots), library,
                link_bound_ms(uniq * rb, slots.numel() * (4 + rb)),
                iters=10, plain_iters=2)
    read = torch.zeros(1, dtype=torch.int64, device=slots.device)
    H.host_gather_rows(table, slots, **kw, _stats=read)  # E counts the bytes it reads
    t.update(rows=slots.numel(), valid_rows=vids.numel(), unique_rows=uniq,
             link_bytes_read=int(read.item()), link_bytes_asked=vids.numel() * rb,
             plan_ms=cuda_ms(lambda: H.host_gather_plan(slots, table.shape[0]), 10)
             if kw.get("_sort", True) else 0.0)
    return link_yardsticks(t, uniq * rb, vids.numel() * rb, link["h2d_GBps"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def quantile(values, q):
    return float(np.quantile(np.asarray(values), q))


def link_rates():
    """Pinned->card and card->pinned rate of a 1 GiB ``copy_``, GB/s, each
    alone and both at once (a 1 GiB copy each way, on two streams: the
    duplex rate counts the bytes of both)."""
    n = 1 << 30
    host = H.pinned_empty((n,), torch.uint8).fill_(1)
    dev = torch.empty((n,), dtype=torch.uint8, device="cuda")
    h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), iters=5, warmup=1)
    d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True), iters=5, warmup=1)
    host2 = H.pinned_empty((n,), torch.uint8).fill_(2)
    dev2 = torch.empty((n,), dtype=torch.uint8, device="cuda")
    streams = (torch.cuda.Stream(), torch.cuda.Stream())

    def duplex():
        cur = torch.cuda.current_stream()
        for st in streams:
            st.wait_stream(cur)
        with torch.cuda.stream(streams[0]):
            dev.copy_(host, non_blocking=True)
        with torch.cuda.stream(streams[1]):
            host2.copy_(dev2, non_blocking=True)
        for st in streams:
            cur.wait_stream(st)

    both = cuda_ms(duplex, iters=5, warmup=1)
    del host, dev, host2, dev2
    free_pinned()
    return {"h2d_GBps": n / h2d / 1e6, "d2h_GBps": n / d2h / 1e6, "bytes": n,
            "h2d_ms": h2d, "d2h_ms": d2h, "duplex_GBps": 2 * n / both / 1e6, "duplex_ms": both}


def device_time(state, batch, step_ms, steps=10, sample_ms=None, step=None):
    """Kernel time per training step (``step``, ``wt.train_step`` unless
    given) under torch.profiler, its share of the unprofiled median step,
    launches per step, and the kernels that take most of it."""
    step = step or wt.train_step
    work = [batch() for _ in range(steps)]
    return profile_steps("profile", lambda i: step(state, *work[i], seed=1000 + i),
                         step_ms, steps, sample_ms)


def profile_steps(tag, step, step_ms, steps, sample_ms=None):
    """Kernel time per call of ``step(i)`` under torch.profiler over
    ``steps`` calls, its share of the unprofiled median ``step_ms``, the
    kernel launches per call, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
    # device-side entries, less user annotations (Optimizer.step's range),
    # which span kernels already counted
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    per_step = sum(e.count for e in kern) / steps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    log(f"[{tag}] {steps} steps: device busy {busy_ms} ms per step, "
        f"{len(kern)} kernel names, {per_step} launches per step; "
        f"busy share of the {step_ms} ms median step: {busy_ms / step_ms}"
        + ("" if sample_ms is None else f"; its sample stage {sample_ms} ms"))
    for e in top:
        log(f"[{tag}]   {e.self_device_time_total / 1e3 / steps:9.4f} ms/step "
            f"{e.count // steps:5d}x  {e.key[:100]}")
    return {"busy_ms": busy_ms, "launches_per_step": per_step, "busy_share": busy_ms / step_ms}


def coherent(emb):
    """Every cached row equals its host row (host_embedding.py:24-27)."""
    torch.cuda.synchronize()
    cached = emb.cache_map >= 0
    lines = emb.cache_map[cached].long()
    return torch.equal(emb.cache_rows[lines].cpu(), emb.host_table[cached.cpu()])


def small_parity():
    """A tiny step on the card and on the CPU from the same numpy data, with
    the embedding in device memory and in the host tier."""
    cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                             batch=32, fanouts=(10, 15))
    rs = np.random.RandomState(7)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:4] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / np.sqrt(cfg.dim)).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    ref_model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu")
    weights = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32) / np.sqrt(v.shape[-1]))
               for k, v in ref_model.state_dict().items()}
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]
    hot = hot_ids_by_degree(row_ptr, HOST_CACHE_RATIO)

    def state(dev, host):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=dev)
        model.load_state_dict(weights)
        if host:
            emb = HostEmbedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(),
                                       cache_ratio=HOST_CACHE_RATIO, device=dev)
            emb.from_array(table, hot_ids=hot)
        else:
            emb = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=dev)
            emb.from_array(table)
        return wt.SageTrainState(
            cfg, GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev),
                                cfg.n_nodes),
            emb, model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
            torch.from_numpy(labels).to(dev))

    runs = {"hbm_gpu": state("cuda", False), "hbm_cpu": state("cpu", False),
            "host_gpu": state("cuda", True), "host_cpu": state("cpu", True)}
    gpu, cpu = runs["hbm_gpu"], runs["hbm_cpu"]
    keys = torch.from_numpy(rs.randint(-2**31, 2**31, 4096).astype(np.int64))
    require(torch.equal(rng.rand_u32(5, keys.cuda(), keys.flip(0).cuda()).cpu(),
                        rng.rand_u32(5, keys, keys.flip(0))), "rng differs between GPU and CPU")
    c0 = torch.from_numpy(batches[0])
    mg = gpu.graph.multilayer_sample(c0.cuda(), cfg.fanouts, seed=0)
    mc = cpu.graph.multilayer_sample(c0, cfg.fanouts, seed=0)
    require(torch.equal(mg.unique_gids.cpu(), mc.unique_gids) and
            torch.equal(mg.unique_mask.cpu(), mc.unique_mask) and
            all(torch.equal(a.nbr_idx.cpu(), b.nbr_idx) and torch.equal(a.mask.cpu(), b.mask)
                for a, b in zip(mg.hops, mc.hops)), "samples differ between GPU and CPU")
    tol = 1e-5  # f32 sums in other orders on the two devices, over three Adam steps
    losses, touched = {k: [] for k in runs}, []
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        for name, st in runs.items():
            cd = c.to(st.labels.device)
            losses[name].append(float(wt.train_step(st, cd, st.labels[cd.long()], seed=i)))
        ml = cpu.graph.multilayer_sample(c, cfg.fanouts, seed=i)
        touched.append(ml.unique_gids[ml.unique_mask])
    rows = torch.unique(torch.cat(touched)).long()
    untouched = torch.ones(cfg.n_nodes, dtype=torch.bool)
    untouched[rows] = False
    tables = {"hbm_gpu": gpu.embedding.table.cpu(), "hbm_cpu": cpu.embedding.table,
              "host_gpu": torch.from_numpy(runs["host_gpu"].embedding.to_array()),
              "host_cpu": runs["host_cpu"].embedding.host_table}
    errs = {}
    for a, b in (("hbm_gpu", "hbm_cpu"), ("host_gpu", "host_cpu"), ("host_gpu", "hbm_gpu")):
        for la, lb in zip(losses[a], losses[b]):
            require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"loss {la} ({a}) vs {lb} ({b})")
        errs[f"{a}/{b}"] = max_err(tables[a][rows], tables[b][rows])
        require(errs[f"{a}/{b}"] <= tol, f"touched rows differ, {a} vs {b}: {errs}")
    for name in ("hbm_gpu", "host_gpu"):
        require(torch.equal(tables[name][untouched], torch.from_numpy(table)[untouched]),
                f"untouched rows changed ({name})")
    require(coherent(runs["host_gpu"].embedding), "host tier: a cached row differs from the host")
    log(f"[parity] 3 tiny steps, losses {json.dumps(losses)}, touched rows {rows.numel()}, "
        f"max row diffs {errs} (tol {tol}); host tier: {len(hot)} rows cached, coherent")


STAMP_SPANS = 12  # spans of stamp_phase's program: 24 stamps a run
STAMP_CAPACITIES = (10, 30, 64)  # below one run's stamps, between one and two, above two


def stamp_program(x):
    """STAMP_SPANS spans over three names, nested two deep, each around a
    small elementwise kernel on ``x``."""
    for i in range(STAMP_SPANS // 2):
        with perf.span(f"outer{i % 3}"):
            x.mul_(1.0001)
            with perf.span("inner"):
                x.add_(1e-4)
    return x


def stamp_phase():
    """``[stamp]``: kernel STAMP against ``perf._stamp_plain``. For each
    capacity, the card's ring after the program run eagerly inside a
    Timeline, and after a graph captured inside one and replayed twice, is
    compared with a CPU Timeline's: the CPU runs the program once eagerly,
    and for the graph the same tags with no host-clock index, twice, into
    ``_stamp_plain``. Tags, cursor and drops must be equal; the card's ns
    never fall."""
    dev = torch.device("cuda")
    out = []
    for cap in STAMP_CAPACITIES:
        for route in ("eager", "graph"):
            x = torch.ones(1 << 16, device=dev)
            ref = perf.Timeline(capacity=1 << 10, device="cpu")
            with ref:
                stamp_program(torch.ones(4))
            tags = ref.buf[1:1 + int(ref.buf[0, 0]), 0].tolist()
            tl = perf.Timeline(capacity=cap, device=dev)
            if route == "eager":
                with tl:
                    stamp_program(x)
            else:
                tags = [t & 0xFFFFFFFF for t in tags] * 2  # a replay's stamps: no host clock
                g = torch.cuda.CUDAGraph()
                with tl:
                    stamp_program(x)  # warm the kernels
                    tl.buf.zero_()
                    with torch.cuda.graph(g):
                        stamp_program(x)
                    g.replay()
                    g.replay()
            want = torch.zeros((cap + 1, 2), dtype=torch.int64)
            for t in tags:
                perf._stamp_plain(want, cap, t)
            rows = tl.read()
            got = tl.buf.cpu()
            n = min(len(tags), cap)
            ns = got[1:1 + n, 1].tolist()
            ties = sum(a == b for a, b in zip(ns, ns[1:]))
            e = {"capacity": cap, "route": route, "asked": len(tags), "cursor": int(got[0, 0]),
                 "dropped": tl.dropped, "rows": len(rows), "ns_ties": ties,
                 "span_ns": ns[-1] - ns[0] if n > 1 else 0}
            require(int(got[0, 0]) == int(want[0, 0]) == len(tags), f"[stamp] cursor: {e}")
            require(tl.dropped == max(len(tags) - cap, 0), f"[stamp] dropped: {e}")
            require(got[1:, 0].tolist() == want[1:, 0].tolist(), f"[stamp] tags differ: {e}")
            require(all(a <= b for a, b in zip(ns, ns[1:])) and (n < 2 or ns[-1] > ns[0]),
                    f"[stamp] the card's clock ran back: {e}, {ns}")
            require([r[:2] for r in rows] == [(ref.names[(t & 0xFFFFFFFF) >> 1],
                                               perf.EXIT if t & 1 else perf.ENTER)
                                              for t in tags[:n]], f"[stamp] rows: {e}")
            require(all((r[3] is None) == (route == "graph") for r in rows),
                    f"[stamp] host clocks: {e}")
            out.append(e)
            log(f"[stamp] {json.dumps(e)}")
    return out


def train_timed(state, batch, steps, seed0, step=None):
    """``steps`` timed steps of ``step`` (``wt.train_step`` unless given),
    each inside a ``utils.perf.Timeline``: per-step device ms (its ``step``
    span) and per-stage device ms (the spans of ``train.STAGES`` directly
    inside it, summed: the hetero step applies once a type), host clock
    ms, losses."""
    step = step or wt.train_step
    step_ms, host_ms, losses = [], [], []
    stage_ms = {s: [] for s in STAGES}
    for i in range(steps):
        c, y = batch()
        torch.cuda.synchronize()
        tl = perf.Timeline(capacity=1024, device=c.device)
        t0 = time.perf_counter()
        with tl:
            loss = step(state, c, y, seed=seed0 + i)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ms = stage_sums(tl)
        step_ms.append(ms["step"])
        for s in STAGES:
            stage_ms[s].append(ms.get(s, 0.0))
        losses.append(float(loss))
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return step_ms, host_ms, stage_ms, losses, c


def stage_sums(tl):
    """Device ms of a Timeline's one ``step`` span and of the spans directly
    inside it, summed by name."""
    out = {}
    for s in tl.spans():
        if s.depth <= 1:
            out[s.name] = out.get(s.name, 0.0) + s.ms
    require(tl.dropped == 0, f"the Timeline dropped {tl.dropped} stamps")
    return out


def timed_steps(tag, state, batch, steps, profile_steps=10, step=None):
    """One warm-up step; ``steps`` timed steps (:func:`train_timed`) with the
    launch counts from 0, reported; then ``profile_steps`` under the profiler
    (:func:`device_time`). ``step`` is ``wt.train_step`` unless given.
    Returns the summary, the launches of the timed steps and the last
    batch's centres."""
    step = step or wt.train_step
    float(step(state, *batch(), seed=1))
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, host_ms, stage_ms, losses, c = train_timed(state, batch, steps, 2, step)
    launches, stamps = read_launches(), perf.STAMP.launches
    peak = torch.cuda.max_memory_allocated()
    report_steps(tag, steps, step_ms, host_ms, stage_ms, losses, peak, launches, stamps)
    med, sample = statistics.median(step_ms), statistics.median(stage_ms["sample"])
    summary = {"step_median_ms": med, "step_p90_ms": quantile(step_ms, 0.9),
               "sample_median_ms": sample, "peak_bytes": peak,
               "stage_medians_ms": {k: statistics.median(v) for k, v in stage_ms.items()},
               "wrapper_launches_per_step": {k: v / steps for k, v in launches.items() if v},
               **device_time(state, batch, med, profile_steps, sample, step)}
    return summary, launches, c


def report_steps(tag, steps, step_ms, host_ms, stage_ms, losses, peak, launches, stamps):
    log(f"[{tag}] {steps} steps at full width: first losses {losses[:5]}, last {losses[-5:]}")
    log(f"[{tag}] step ms (Timeline) median {statistics.median(step_ms)}, "
        f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; "
        f"sample stage median {statistics.median(stage_ms['sample'])}; "
        f"host clock median {statistics.median(host_ms)}; "
        f"peak memory {peak} bytes ({peak / 2**30:.2f} GiB); hand-written kernel launches "
        f"{launches} ({sum(launches.values()) / steps} per step; the Timeline's stamps "
        f"{stamps / steps} per step beside them)")
    log(f"[{tag}] stage ms medians (Timeline): "
        + json.dumps({s: statistics.median(v) for s, v in stage_ms.items()}))


def host_gather_phase(link):
    """The host tier's gather at bench_host_gather's shapes (empty cache)."""
    n, dim, batch = 4_000_000, 256, 1 << 19
    t0 = time.perf_counter()
    emb = HostEmbedding.create(n, dim, cache_ratio=1e-9)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    emb.init(gen)  # random rows, so bit-equality says something
    torch.cuda.synchronize()
    asked, held = pinned_bytes([emb.host_table])
    log(f"[host_gather] [{n}, {dim}] f32 pinned table in {time.perf_counter() - t0:.2f} s: "
        f"{asked} bytes in its allocation; pinned bytes held {held} (the kernels' library's "
        f"and the caching host allocator's)")
    span = int(batch * 1.25)
    base = int(torch.randint(0, n - span, (1,), generator=gen, device="cuda"))
    regimes = {
        "uniform": torch.randint(0, n, (batch,), generator=gen, device="cuda", dtype=torch.int32),
        "clustered": base + torch.randint(0, span, (batch,), generator=gen, device="cuda",
                                          dtype=torch.int32),
    }
    out, errs = [], []
    for regime, ids in regimes.items():
        calls = []
        torch.cuda.synchronize()
        reset_launches()
        with capture_kw(host_mod, "host_gather_rows", calls):
            rows = emb.gather(ids)
            torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        require(launches.get("host_gather", 0) > 0 and launches.get("row_gather", 0) > 0,
                f"host gather ({regime}) did not launch kernels E and A: {launches}")
        (table, slots), kw = calls[0]
        ref = H.host_gather_rows_plain(table, slots)
        err = max_err(H.host_gather_rows(table, slots, **kw), ref)
        require(err == 0.0 and torch.equal(rows, ref),
                f"host_gather ({regime}) differs from its plain version: {err}")
        errs.append({"case": f"bench {regime}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"bench {regime} [{batch}] of [{n}, {dim}]", table, slots, link, kw)
        t.update(regime=regime, launches=launches, gather_ms=cuda_ms(lambda: emb.gather(ids), 10))
        rb = dim * 4
        if regime == "clustered":  # row 10's yardstick: the span's copy_, then a take
            lo, hi = int(slots.min()), int(slots.max())
            span_dev = torch.empty((hi - lo + 1, dim), device="cuda")
            rel = (slots - lo).long()
            t["library_cpu_ms"] = t["library_ms"]
            t["library_ms"] = cuda_ms(lambda: torch.index_select(
                span_dev.copy_(emb.host_table[lo:hi + 1], non_blocking=True), 0, rel),
                iters=5, warmup=1)
            t.update(span_rows=hi - lo + 1, library="span copy_ + index_select",
                     library_cpu="CPU index_select + copy")
            del span_dev
        else:
            t["library"] = "CPU index_select + copy"
        log(f"[host_gather] {regime}: E {t['ms']} ms for {batch} rows of {rb} B, "
            f"{t['delivered_GBps']} GB/s delivered = {t['peak_share']} of the link's "
            f"{LINK_BYTES_PER_S / 1e9} GB/s peak, {t['copy_share']} of its {link['h2d_GBps']} "
            f"GB/s copy_; whole gather {t['gather_ms']} ms; bound {t['bound_ms']} ms (at the "
            f"copy_ rate {t['copy_ms']} ms); plain {t['plain_ms']} ms; library {t['library_ms']} ms"
            + (f" (CPU route {t['library_cpu_ms']} ms)" if "library_cpu_ms" in t else "")
            + f"; {t['unique_rows']} unique rows: E read {t['link_bytes_read']} bytes across the "
            f"link ({t['link_bytes_asked']} asked for), its sort {t['plan_ms']} ms of it; "
            f"launches {launches}")
        out.append(t)
        del calls, table, slots, rows, ref
    del emb, regimes
    log(f"[host_gather] table freed; host cache emptied: {free_pinned()}")
    for t in out:  # the port's bench_host_gather at the same shapes, timed by measure_chain
        gbps, dt = bench_host_gather(n, dim, batch, clustered=t["regime"] == "clustered")
        t.update(bench_host_gather_ms=dt * 1e3, bench_host_gather_GBps=gbps)
        log(f"[host_gather] bench_host_gather({t['regime']}): {dt * 1e3} ms a gather (device "
            f"time, a CUDA graph of 8 by utils.perf.measure_chain), {gbps} GB/s of rows; host "
            f"cache emptied: {free_pinned()}")
    return out, errs


def check_host_steps(emb, calls_e, calls_f, snap, sample, link):
    """E's calls of the host tier (the step's gather and the composed
    route's reads) and F's (the composed route's write-backs) against their
    plain versions; F by its written rows and a sample of untouched rows."""
    errs, times = {"E": [], "F": []}, {"E": [], "F": []}
    torch.cuda.synchronize()
    for i, ((table, slots), kw) in enumerate(calls_e):
        err = max_err(H.host_gather_rows(table, slots, **kw),
                      H.host_gather_rows_plain(table, slots))
        require(err == 0.0, f"host_gather step call{i} differs from its plain version: {err}")
        regime = ("step gather (misses)" if i == 0
                  else "composed apply (sorted unique slots)")
        errs["E"].append({"case": f"step call{i}", "max_abs_err": err, "tol": 0.0})
        t = time_host_gather(f"step call{i} [{slots.numel()}] of {list(table.shape)}",
                             table, slots, link, kw)
        t["regime"] = regime
        log(f"[check] host_gather step call{i} ({regime}): E {t['ms']} ms, read "
            f"{t['link_bytes_read']} bytes across the link ({t['unique_rows']} distinct rows, "
            f"{t['link_bytes_asked']} bytes asked for), sort {t['plan_ms']} ms")
        times["E"].append(t)
    names = {id(emb.host_table): "table", **{id(t): s for s, t in emb.host_slots.items()}}
    for i, (table, slots, rows) in enumerate(calls_f):
        n, rb = table.shape[0], table.shape[1] * table.element_size()
        valid = (slots >= 0) & (slots < n)
        vids = slots[valid].long().cpu()
        written = table[vids]
        err = max_err(written, rows[valid].cpu())
        require(err == 0.0, f"host_scatter step call{i}: written rows differ: {err}")
        name = names[id(table)]
        keep = ~torch.isin(sample, vids)
        require(torch.equal(table[sample[keep]], snap[name][keep]),
                f"host_scatter step call{i}: an untouched row of {name} changed")
        errs["F"].append({"case": f"step call{i} ({name})", "max_abs_err": err, "tol": 0.0,
                          "untouched_rows_checked": int(keep.sum())})
        vrows = rows[valid]
        staging = H.pinned_empty(tuple(vrows.shape), vrows.dtype)

        def library():  # a D2H copy of the valid rows, then a CPU index_copy_
            staging.copy_(vrows)
            table.index_copy_(0, vids, staging)

        t = timings(f"step call{i} [{slots.numel()}] into [{n}, {table.shape[1]}] ({name})",
                    lambda: H.host_scatter_rows(table, slots, rows),
                    lambda: H.host_scatter_rows_plain(table, slots, rows), library,
                    link_bound_ms(vids.numel() * rb, slots.numel() * 4 + vids.numel() * rb),
                    iters=10, plain_iters=2)
        t.update(valid_rows=vids.numel(), library="D2H copy + CPU index_copy_")
        times["F"].append(link_yardsticks(t, vids.numel() * rb, vids.numel() * rb,
                                          link["d2h_GBps"]))
    return errs, times


@contextlib.contextmanager
def capture_host_apply(calls):
    """Record every ``apply_rows_host`` call of the host tier's apply (as
    ``HostEmbedding.apply_gradients`` looks it up) into ``calls``, with the
    rows it is about to touch as they were before it (:func:`host_rows`),
    so that a check replays the call from the same state."""
    fn = host_mod.apply_rows_host

    def rec(table, slots, ids, grads, optimizer, step, lr, *, lines, cache_rows):
        c = {"table": table, "slots": slots, "ids": ids, "grads": grads, "optimizer": optimizer,
             "step": step, "lr": lr, "lines": lines, "cache_rows": cache_rows}
        valid = (ids >= 0) & (ids < table.shape[0])
        c["vids"] = ids[valid].long().cpu()
        c["hit_lines"] = lines[valid & (lines >= 0)].long()
        c["before"] = host_rows(c)
        calls.append(c)
        return fn(table, slots, ids, grads, optimizer, step, lr, lines=lines,
                  cache_rows=cache_rows)

    host_mod.apply_rows_host = rec
    try:
        yield calls
    finally:
        host_mod.apply_rows_host = fn


def host_rows(c):
    """Copies of the rows an apply call touches: its valid slots' rows of
    the table and of every state table, and its hit lines of the cache."""
    torch.cuda.synchronize()
    return {"table": c["table"][c["vids"]], "cache": c["cache_rows"][c["hit_lines"]],
            **{k: v[c["vids"]] for k, v in c["slots"].items()}}


def restore_host_rows(c, rows):
    """Write :func:`host_rows`' copies back in place."""
    torch.cuda.synchronize()
    c["table"][c["vids"]] = rows["table"]
    c["cache_rows"][c["hit_lines"]] = rows["cache"]
    for k, v in c["slots"].items():
        v[c["vids"]] = rows[k]


def host_apply_composed(c, opt=None, slots=None, record=None):
    """The host tier's apply before kernel L's host route: kernel E on the
    table and each slot, the optimizer's update on the card, kernel F on
    each, kernel B on the cache lines. ``record``: lists that get E's
    ``(args, kwargs)`` (with an int64 ``_stats`` to which E adds the bytes
    it reads), F's and B's arguments."""
    def gather(t, s):
        kw = {"_sort": False}
        if record is not None:
            kw["_stats"] = record["read"]
            record["E"].append(((t, s), {"_sort": False}))
        return H.host_gather_rows(t, s, **kw)

    def scatter(t, s, rows):
        if record is not None:
            record["F"].append((t, s, rows))
        return H.host_scatter_rows(t, s, rows)

    def lines(t, s, rows):
        if record is not None:
            record["B"].append((t, s, rows))
        return G.scatter_rows(t, s, rows)

    OK._composed_host(gather, scatter, lines, c["table"], c["slots"] if slots is None else slots,
                      c["ids"], c["grads"], opt or c["optimizer"], c["step"], c["lr"],
                      c["lines"], c["cache_rows"])


def host_apply_fused(c, opt=None, slots=None):
    OK.apply_rows_host(c["table"], c["slots"] if slots is None else slots, c["ids"], c["grads"],
                       opt or c["optimizer"], c["step"], c["lr"], lines=c["lines"],
                       cache_rows=c["cache_rows"])


def host_apply_route(c, route, opt=None, slots=None, record=None):
    """One route of the apply call from the rows as they were before it;
    returns the touched rows after it."""
    restore_host_rows(c, c["before"])
    if route == "host":
        host_apply_fused(c, opt, slots)
    else:
        host_apply_composed(c, opt, slots, record)
    return host_rows(c)


def same_host_rows(a, b):
    return all(bit_equal(a[k], b[k]) for k in a)


def host_apply_bounds(c):
    """The apply call's bytes and bounds: each valid row's table row and
    state rows read from the host once and written once; on the card the
    ids, lines and gradients read and the hit lines written. Both
    directions of the link at once (the host route can), and one after the
    other (the composed route's order)."""
    t, ids = c["table"], c["ids"]
    valid, hits, D = c["vids"].numel(), c["hit_lines"].numel(), t.shape[1]
    row = D * (t.element_size() + 4 * len(c["slots"]))
    hbm = 2 * ids.numel() * 4 + valid * D * 4 + hits * D * t.element_size()
    link = valid * row
    return {"valid": valid, "hits": hits, "link_read_bytes": link, "link_write_bytes": link,
            "hbm_bytes": hbm, "duplex_bound_ms": link_bound_ms(link, hbm)[0],
            "in_turn_bound_ms": link_bound_ms(2 * link, hbm)[0]}


def host_apply_bits(c, tag, others=()):
    """Kernel L's host route at an apply call, bit-equal to the composed
    route and to what the call itself wrote, each from the rows as they
    were before the call, under the call's optimizer and ``others`` (their
    state rows the call's m and v rows); the touched rows left as the call
    wrote them. Returns the checks, the composed route's recorded calls
    (:func:`host_apply_composed`) and the touched rows as the call wrote
    them."""
    after = host_rows(c)
    record = {"E": [], "F": [], "B": [],
              "read": torch.zeros(1, dtype=torch.int64, device=c["ids"].device)}
    composed = host_apply_route(c, "composed", record=record)
    fused = host_apply_route(c, "host")
    case = (f"{tag} [{c['ids'].numel()}] ({c['vids'].numel()} valid, "
            f"{c['hit_lines'].numel()} cached) into {list(c['table'].shape)} "
            f"{str(c['table'].dtype)[6:]}, {c['optimizer'].name}")
    require(same_host_rows(fused, composed) and same_host_rows(fused, after),
            f"sparse_apply_host differs from the composed route or the step ({case})")
    errs = [{"case": case, "setting": c["optimizer"].name, "max_abs_err": 0.0, "tol": 0.0}]
    m, v = c["slots"]["m"], c["slots"]["v"]
    for opt in others:
        slots = {n: m if n == "m" else v for n in opt.slot_names}
        setting = (opt.name + (" adam_w" if getattr(opt, "adam_w", False) else "")
                   + f", weight decay {opt.weight_decay}")
        name = f"{case[:-len(c['optimizer'].name)]}{setting}"
        a = host_apply_route(c, "host", opt, slots)
        b = host_apply_route(c, "composed", opt, slots)
        require(same_host_rows(a, b), f"sparse_apply_host differs from the composed route "
                                      f"({name})")
        errs.append({"case": name, "setting": setting, "max_abs_err": 0.0, "tol": 0.0})
    restore_host_rows(c, after)
    return errs, record, after


def check_host_apply(c, link):
    """Kernel L's host route at the host-tier step's apply call: bit-equal
    to the composed route and to the step's own result under the call's
    optimizer and the registry's others (:func:`host_apply_bits`); both
    routes timed in turns by device time (``measure_chain``,
    HOST_APPLY_ITERS calls) and by CUDA events, beside the two bounds, the
    host route's plain version and the bytes E read on the composed route;
    the touched rows left as the step wrote them. Returns (checks, the host
    route's times, the composed route's E, F and B calls)."""
    errs, record, after = host_apply_bits(c, "host tier step apply", APPLY_OTHER_OPTIMIZERS)
    t = {"case": errs[0]["case"], **host_apply_bounds(c),
         "composed_e_read_bytes": int(record["read"].item()),
         "library_ms": None, "bound_by": "bytes"}
    rounds = {"host": [], "composed": []}
    for route in ("host", "composed", "composed", "host"):
        fn = host_apply_fused if route == "host" else host_apply_composed
        rounds[route].append(measure_chain(lambda i: fn(c), HOST_APPLY_ITERS) * 1e3)
    t.update(device_ms=statistics.median(rounds["host"]), device_ms_turns=rounds["host"],
             composed_device_ms=statistics.median(rounds["composed"]),
             composed_device_ms_turns=rounds["composed"],
             ms=cuda_ms(lambda: host_apply_fused(c), 5, warmup=1),
             composed_ms=cuda_ms(lambda: host_apply_composed(c), 5, warmup=1),
             plain_ms=cuda_ms(lambda: OK.apply_rows_host_plain(
                 c["table"], c["slots"], c["ids"], c["grads"], c["optimizer"], c["step"], c["lr"],
                 lines=c["lines"], cache_rows=c["cache_rows"]), 1, warmup=0, lead=False))
    restore_host_rows(c, after)
    t.update(bound_ms=t["duplex_bound_ms"], bound_share=t["duplex_bound_ms"] / t["device_ms"],
             in_turn_share=t["in_turn_bound_ms"] / t["device_ms"],
             composed_in_turn_share=t["in_turn_bound_ms"] / t["composed_device_ms"],
             host_over_composed=t["device_ms"] / t["composed_device_ms"],
             duplex_copy_ms=2 * t["link_read_bytes"] / (link["duplex_GBps"] * 1e6))
    log(f"[host_tier] sparse_apply_host at the step's apply ({t['valid']} valid rows, "
        f"{t['hits']} cached; {t['link_read_bytes']} bytes read and as many written over the "
        f"link; the composed route's E read {t['composed_e_read_bytes']}): device ms "
        f"{t['device_ms']} (turns {rounds['host']}) against the composed route's (E x3, update, "
        f"F x3, B) {t['composed_device_ms']} (turns {rounds['composed']}), ratio "
        f"{t['host_over_composed']}; bounds {t['duplex_bound_ms']} ms both directions at once "
        f"(share {t['bound_share']}), {t['in_turn_bound_ms']} ms one after the other (host "
        f"{t['in_turn_share']}, composed {t['composed_in_turn_share']}); the same bytes at the "
        f"[link] duplex copy_ rate {t['duplex_copy_ms']} ms ([link] copy_ {link['h2d_GBps']} "
        f"GB/s pinned->card, {link['d2h_GBps']} card->pinned, {link['duplex_GBps']} both at "
        f"once); CUDA events {t['ms']} (composed {t['composed_ms']}); plain version "
        f"{t['plain_ms']} ms")
    log(f"[host_tier] sparse_apply_host bit-equal to the composed route and to the step at "
        f"{len(errs)} settings: " + "; ".join(e["setting"] for e in errs))
    return errs, t, record


def host_tier_layout(emb):
    """The host tier's memory as ``HostEmbedding`` holds it: its tables' row
    stride and how each was allocated."""
    st = emb.host_table.stride(0) * emb.host_table.element_size()
    if not hasattr(H, "host_zeros"):  # an older tree: a pinned tensor of PyTorch's each
        return f"a pinned tensor each, table row stride {st} bytes"
    return (f"a cudaHostAlloc allocation of the kernels' library each, table row stride {st} "
            f"bytes, each request rounded up to a multiple of {H.HOST_ROUND} bytes")


class ComposedLazyAdam(LazyAdam):
    """LazyAdam from outside the registry's types: ``apply_route`` sends it
    down the composed route (E, its update, F, B)."""


def host_tier_phase(cfg, link):
    """The sampled GraphSAGE step with the table, m and v in pinned host
    memory (HostEmbedding, cache_ratio HOST_CACHE_RATIO)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = wt.build_synthetic(cfg, device=dev, seed=0, host_cache_ratio=HOST_CACHE_RATIO)
    torch.cuda.synchronize()
    emb = state.embedding
    host_tensors = [emb.host_table, *emb.host_slots.values()]
    asked, held = pinned_bytes(host_tensors)
    layout = host_tier_layout(emb)
    log(f"[host_tier] state built in {time.perf_counter() - t0:.2f} s: {emb.hot_cap} cache "
        f"lines ({emb.cache_rows.nbytes} bytes on the card); the table, m and v in "
        f"{len(host_tensors)} pinned, mapped allocations of {asked} bytes in all ({layout}); "
        f"pinned bytes held {held} (the kernels' library's and the caching host allocator's)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def batch():
        c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                          dtype=torch.int32)
        return c, state.labels[c.long()]

    # a sample of rows of the table, m and v, to show the apply leaves untouched rows alone
    sample = torch.randperm(cfg.n_nodes, generator=torch.Generator().manual_seed(6))[:65536]
    snap = {"table": emb.host_table[sample]}
    snap.update({s: t[sample] for s, t in emb.host_slots.items()})
    calls = {k: [] for k in "ACDEL"}
    reset_launches()
    with capture(host_mod, "gather_rows", calls["A"]), \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]), \
            capture_kw(host_mod, "host_gather_rows", calls["E"]), \
            capture_host_apply(calls["L"]):
        c, y = batch()
        loss0 = float(wt.train_step(state, c, y, seed=0))
    require(np.isfinite(loss0), f"first host-tier step loss {loss0}")
    step_launches = {k: v for k, v in read_launches().items() if v}
    per_step = {k: len(v) for k, v in calls.items()}
    # A: the cache hits; C: a hop each; D: a layer each; E: the gather's misses; L: the apply
    # (kernel L's host route: the table's, m's and v's rows read, updated and written back, and
    # the cached lines among them rewritten); F and B no longer run
    require(per_step == {"A": 1, "C": 2, "D": 2, "E": 1, "L": 1},
            f"unexpected host-tier calls per step {per_step}")
    require(step_launches.get("sparse_apply_host") == 1 and "host_scatter" not in step_launches
            and "row_scatter" not in step_launches and "sparse_apply" not in step_launches,
            f"the host-tier step's apply did not run one launch of L's host route alone: "
            f"{step_launches}")
    ml = state.graph.multilayer_sample(c, cfg.fanouts, seed=0)
    ids = ml.unique_gids[ml.unique_mask]
    hit = emb.cache_hit_fraction(ids)
    misses = int(((calls["E"][0][0][1] >= 0)).sum())
    log(f"[host_tier] captured step: calls {per_step}, launches {step_launches}, loss "
        f"{loss0:.5f}, {ids.numel()} unique rows, cache hit fraction {hit}, {misses} rows "
        f"fetched from the host")
    l_errs, l_time, composed = check_host_apply(calls["L"][0], link)
    # E: the step's gather and the composed route's reads; F: the composed route's write-backs
    errs, times = check_host_steps(emb, calls["E"] + composed["E"], composed["F"], snap, sample,
                                   link)
    errs["L_host"] = l_errs
    # A on the cache hits' lines of cache_rows, B on the composed route's rewrite of the
    # cached lines (the new rows of the step's hits, -1 for the rest)
    for key, check, args in (("A", check_gather, calls["A"]),
                             ("B", check_scatter, composed["B"])):
        errs[key], times[key] = check(args)
        for e in errs[key] + times[key]:
            e["case"] = "host tier " + e["case"]
    require(coherent(emb), "host tier: a cached row differs from its host row")
    for key, name in (("E", "host_gather"), ("F", "host_scatter"), ("A", "row_gather"),
                      ("B", "row_scatter")):
        log(f"[check] {name} (host tier): " + json.dumps(errs[key]))
    del calls, snap, composed

    # the composed route through the entry point: a LazyAdam subclass
    opt = emb.optimizer
    emb.optimizer = ComposedLazyAdam(**dataclasses.asdict(opt))
    reset_launches()
    for i in range(HOST_COMPOSED_STEPS):
        require(np.isfinite(float(wt.train_step(state, *batch(), seed=100 + i))),
                "non-finite loss on the host tier's composed route")
    composed_launches = read_launches()
    emb.optimizer = opt
    per = {k: composed_launches[k] / HOST_COMPOSED_STEPS for k in (
        "host_gather", "host_scatter", "row_scatter", "sparse_apply_host")}
    require(per == {"host_gather": 4, "host_scatter": 3, "row_scatter": 1,
                    "sparse_apply_host": 0},
            f"the host tier's composed route ran other launches a step: {per}")
    log(f"[host_tier] {HOST_COMPOSED_STEPS} steps under a LazyAdam subclass (the composed "
        f"route): launches a step {per}")

    _, launches, c = timed_steps("host_tier", state, batch, HOST_STEPS, profile_steps=5)
    path = (G.ROW_GATHER, sampling_mod.SAMPLE_HOP, S.NEIGHBOR_AGG, H.HOST_GATHER,
            OK.SPARSE_APPLY_HOST)
    require(all(launches[k.name] > 0 for k in path), f"a kernel of the host tier never ran: {launches}")
    require(launches["sample_hop_uniform"] == 2 * HOST_STEPS and launches["sample_cols"] == 0,
            f"the host tier's sampler did not run one kernel C launch per hop: {launches}")
    require(launches["host_gather"] == HOST_STEPS and launches["sparse_apply_host"] == HOST_STEPS
            and launches["host_scatter"] == 0 and launches["row_scatter"] == 0,
            f"the host tier did not run E and L's host route once a step, and F and B never: "
            f"{launches}")
    require(bool(torch.isfinite(emb.gather(c)).all()), "non-finite host-tier rows")
    require(coherent(emb), "host tier: the cache lost coherence over the timed steps")
    log(f"[host_tier] pinned {asked} bytes asked ({layout}; {held} held); "
        f"cache hit fraction {hit}; link h2d {link['h2d_GBps']} GB/s, d2h {link['d2h_GBps']} "
        f"GB/s, both at once {link['duplex_GBps']} GB/s")
    l_time.update(pinned_bytes=asked, pinned_held=held, layout=layout)
    del state, emb, host_tensors
    free_pinned()
    return errs, times, launches, composed_launches, l_time


# ---------------------------------------------------------------------------
# the full-graph paths: kernels G (CSR SpMM) and H (CSR SDDMM)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def capture_kw(module, name, calls):
    """As :func:`capture`, keeping each call's ``(args, kwargs)``."""
    fn = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def longest_row(row_ptr):
    return int((row_ptr[1:] - row_ptr[:-1]).max()) if row_ptr.numel() > 1 else 0


def g_tol(ref, K, dtype=torch.float32):
    """Kernel G against its plain version: both add up to K values (K the
    CSR's longest row) in other orders, so K f32 ulps of the largest output,
    plus one bf16 ulp when the output is rounded to bf16."""
    scale = max(1.0, ref.float().abs().max().item())
    return K * F32_EPS * scale + (BF16_EPS * scale if dtype == torch.bfloat16 else 0.0)


def h_tol(ref, D):
    """Kernel H against its plain version: a dot of D products in other
    orders, D f32 ulps of the largest value."""
    return D * F32_EPS * max(1.0, ref.abs().max().item())


def sparse_csr(row_ptr, col, vals, n_cols):
    """The CSR as a torch sparse tensor, for the cuSPARSE yardsticks."""
    return torch.sparse_csr_tensor(row_ptr, col, vals, size=(row_ptr.numel() - 1, n_cols),
                                   check_invariants=False)


def spmm_stats(args, kw):
    """Kernel G's own counts for one call: tiles staged, bytes of x staged,
    tiles and edges left to device memory (none where the tree's G does
    not count)."""
    if "_stats" not in inspect.signature(S.csr_spmm).parameters:
        return {}
    st = torch.zeros(4, dtype=torch.int64, device=args[2].device)
    S.csr_spmm(*args, **kw, _stats=st)
    return dict(zip(("tiles_staged", "staged_bytes", "tiles_from_device_memory",
                     "edges_from_device_memory"), st.tolist()))


def spmm_times(case, args, kw, library, iters=20, plain_iters=3):
    """One kernel G call (``csr_spmm(*args, **kw)``) held against its plain
    version, then timed (CUDA events, and device time from a CUDA graph)
    beside its bound, the plain version and the cuSPARSE call ``library``,
    with G's own counts."""
    row_ptr, col, x = args
    plain_kw = {k: v for k, v in kw.items() if k != "route"}
    ref = S.csr_spmm_plain(*args, **plain_kw)
    K = longest_row(row_ptr)
    tol = g_tol(ref, K, x.dtype)
    err = max_err(S.csr_spmm(*args, **kw), ref)
    require(err <= tol, f"csr_spmm {case} err {err} > tol {tol}")
    E, D, es = col.numel(), x.shape[1], x.element_size()
    rows_read = torch.unique(col).numel()
    nbytes = (rows_read * D * es + ref.numel() * es + 4 * E + 4 * row_ptr.numel()
              + (4 * E if kw.get("edge_weight") is not None else 0))
    b_ms, by = bound_ms(nbytes, 2.0 * E * D)
    t = {"case": case, "ms": cuda_ms(lambda: S.csr_spmm(*args, **kw), iters),
         "device_ms": graph_ms(lambda: S.csr_spmm(*args, **kw)),
         "plain_ms": cuda_ms(lambda: S.csr_spmm_plain(*args, **plain_kw), plain_iters,
                             warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D, "longest_row": K, "source_rows_read": rows_read,
         "per_edge_row_bytes": E * D * es, **spmm_stats(args, kw)}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def check_routes(case, args, kw):
    """Kernel G staged (the default) bit-equal to G with staging off, every
    tile through device memory, and to itself."""
    out = S.csr_spmm(*args, **kw)
    require(bit_equal(out, S.csr_spmm(*args, **kw, _stage=False)),
            f"csr_spmm {case}: the staged route differs from the device route")
    require(bit_equal(out, S.csr_spmm(*args, **kw)), f"csr_spmm {case}: two runs differ")
    return {"case": f"{case}: staged == device route, two runs bit-identical",
            "max_abs_err": 0.0, "tol": 0.0}


def sddmm_times(case, args, library, iters=20, plain_iters=3):
    """One kernel H call held against its plain version, then timed."""
    row_ptr, col, a, b = args
    ref = S.csr_sddmm_plain(*args)
    tol = h_tol(ref, a.shape[1])
    err = max_err(S.csr_sddmm(*args), ref)
    require(err <= tol, f"csr_sddmm {case} err {err} > tol {tol}")
    require(torch.equal(S.csr_sddmm(*args), S.csr_sddmm(*args)),
            f"csr_sddmm {case}: two runs differ")
    E, D, es = col.numel(), a.shape[1], a.element_size()
    a_rows = int(((row_ptr[1:] - row_ptr[:-1]) > 0).sum())
    b_rows = torch.unique(col).numel()
    nbytes = (a_rows + b_rows) * D * es + 4 * E + 4 * row_ptr.numel() + 4 * E
    b_ms, by = bound_ms(nbytes, 2.0 * E * D)
    # H's own counts: the tiles it staged in shared memory and the bytes of
    # b[lo..hi] and a it staged there, the tiles and edges it read from
    # device memory
    stats = torch.zeros(4, dtype=torch.int64, device=a.device)
    S.csr_sddmm(*args, _stats=stats)
    staged, staged_bytes, dev_tiles, dev_edges = stats.tolist()
    t = {"case": case, "ms": cuda_ms(lambda: S.csr_sddmm(*args), iters),
         "plain_ms": cuda_ms(lambda: S.csr_sddmm_plain(*args), plain_iters, warmup=1),
         "library_ms": cuda_ms(library, iters), "bound_ms": b_ms, "bound_by": by,
         "edges": E, "dim": D, "tiles_staged": staged, "staged_bytes": staged_bytes,
         "tiles_from_device_memory": dev_tiles, "edges_from_device_memory": dev_edges,
         "per_edge_row_bytes": E * D * es}
    t["Medges_per_s"] = E / t["ms"] / 1e3
    t["bound_share"] = b_ms / t["ms"]
    return {"case": case, "max_abs_err": err, "tol": tol}, t


def fmt_g_stats(t):
    return (f"G counted {t['tiles_staged']} tiles staging {t['staged_bytes']} bytes of x in "
            f"shared memory ({t['per_edge_row_bytes']} bytes of x rows if read per edge) and "
            f"{t['tiles_from_device_memory']} tiles ({t['edges_from_device_memory']} edges) "
            f"left to device memory")


def fmt_staged(t):
    return (f"H counted {t['tiles_staged']} tiles staging {t['staged_bytes']} bytes in shared "
            f"memory ({t['per_edge_row_bytes']} bytes of b rows if read per edge) and "
            f"{t['tiles_from_device_memory']} tiles ({t['edges_from_device_memory']} edges) "
            f"reading device memory; two runs bit-identical")


def fmt_times(t):
    return (f"{t['ms']} ms ({t['Medges_per_s']} Medges/s, {t['bound_share']} of the "
            f"{t['bound_ms']} ms bound, {t['bound_by']}"
            + (f"; device {t['device_ms']} ms" if "device_ms" in t else "")
            + f"); plain {t['plain_ms']} ms; cuSPARSE {t['library_ms']} ms"
            + (f"; kernels a call {t['kernels_seen']} (read from its CUDA graph)"
               if "kernels_seen" in t else ""))


def fg_spmm_phase(g, fg):
    """Kernel G at bench_spmm_clustered's shapes (x [2^20, 256] f32): the
    forward as mean, sum and weighted sum, and the forward plus backward of
    ``sum(spmm_window(..., reduce="mean"))`` with its transposed launch."""
    n, dim = g.node_count, 256
    E = g.edge_count
    rp, col = g.row_ptr, g.col
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    x = torch.randn(n, dim, generator=gen, device="cuda")
    w = torch.rand(E, generator=gen, device="cuda")
    dst = S.csr_edge_dst(rp, E)
    inv_deg = 1.0 / (rp[1:] - rp[:-1]).clamp(min=1).float()
    errs, times = [], []
    for case, reduce, weight, vals in (("mean", "mean", None, inv_deg[dst]),
                                       ("sum", "sum", None, torch.ones(E, device="cuda")),
                                       ("weighted sum", "sum", w, w)):
        lib = sparse_csr(rp, col, vals, n)
        kw = {"reduce": reduce, "edge_weight": weight}
        e, t = spmm_times(f"bench {case} [{n}, {dim}] f32", (rp, col, x), kw,
                          lambda: torch.sparse.mm(lib, x))
        t.update(launch_structure(f"[fg_spmm] G {case}", lambda: S.csr_spmm(rp, col, x, **kw),
                                  G_KERNELS))
        errs += [e, check_routes(f"bench {case}", (rp, col, x), kw)]
        times.append(t)
        require(t["tiles_staged"] == -(-n // S.SPMM_TILE) and t["tiles_from_device_memory"] == 0,
                f"[fg_spmm] G {case}: not every tile of the bench graph was staged: {t}")
        log(f"[fg_spmm] G {case}: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol {e['tol']}); "
            + fmt_g_stats(t) + "; bit-equal to the device route and to itself")
        del lib
    # the bench degrees with uniform columns: no tile's window fits
    ucol = random_cols(rp, n, gen)
    lib = sparse_csr(rp, ucol, inv_deg[dst], n)
    kw = {"reduce": "mean"}
    e, t = spmm_times(f"uniform columns mean [{n}, {dim}] f32", (rp, ucol, x), kw,
                      lambda: torch.sparse.mm(lib, x))
    require(t["tiles_staged"] == 0, f"[fg_spmm] G staged a tile of uniform columns: {t}")
    errs += [e, check_routes("uniform columns mean", (rp, ucol, x), kw)]
    times.append(t)
    log(f"[fg_spmm] G uniform columns mean: " + fmt_times(t) + f"; err {e['max_abs_err']} "
        f"(tol {e['tol']}); " + fmt_g_stats(t))
    del lib, ucol

    # forward + backward of spmm_window's mean with respect to x
    xg = x.clone().requires_grad_()
    plan = {"window": fg.window, "edge_cap": fg.edge_cap}

    def fwd_bwd():
        xg.grad = None
        S.spmm_window(rp, col, xg, reduce="mean", **plan).sum().backward()

    calls = []
    with capture_kw(S, "csr_spmm", calls):
        fwd_bwd()
        torch.cuda.synchronize()
    require(len(calls) == 2 and calls[1][1].get("route") == "transposed",
            f"spmm_window's forward + backward made {len(calls)} G calls: "
            f"{[c[1].get('route', 'forward') for c in calls]}")
    (t_rp, t_col, ctd), kw = calls[1]
    K_t = longest_row(t_rp)
    # the plain backward, independently: dx[col_e] += ct[dst_e] / deg, chunked
    dx_ref = torch.zeros_like(x)
    ct = torch.ones(n, dim, device="cuda") * inv_deg[:, None]
    for i in range(0, E, S.PLAIN_CHUNK):
        j = slice(i, i + S.PLAIN_CHUNK)
        dx_ref.index_add_(0, col[j].long(), ct[dst[j]])
    del ct
    err_dx = max_err(xg.grad, dx_ref)
    tol_dx = g_tol(dx_ref, K_t)
    require(err_dx <= tol_dx, f"spmm_window mean dx err {err_dx} > tol {tol_dx}")
    lib_t = sparse_csr(t_rp, t_col, torch.ones(E, device="cuda"), n)
    e_t, t_t = spmm_times(f"bench backward dx (transposed CSR, longest row {K_t})",
                          (t_rp, t_col, ctd), kw, lambda: torch.sparse.mm(lib_t, ctd))
    t_t.update(launch_structure("[fg_spmm] G transposed",
                                lambda: S.csr_spmm(t_rp, t_col, ctd, **kw), G_KERNELS))
    e_dx = {"case": "bench backward dx vs index_add_ scatter", "max_abs_err": err_dx,
            "tol": tol_dx}
    e_r = check_routes("bench backward dx", (t_rp, t_col, ctd), kw)
    log(f"[fg_spmm] G transposed (backward dx): " + fmt_times(t_t)
        + f"; err {e_t['max_abs_err']} (tol {e_t['tol']}); whole dx against an index_add_ "
        f"scatter: err {err_dx} (tol {tol_dx}); " + fmt_g_stats(t_t)
        + "; bit-equal to the device route and to itself")
    fb_ms = cuda_ms(fwd_bwd, 5, warmup=1)
    tr_ms = cuda_ms(lambda: S.transpose_csr(rp, col, n), 5, warmup=1)
    fb = {"fwd_bwd_ms": fb_ms, "fwd_bwd_Medges_per_s": E / fb_ms / 1e3,
          "transpose_csr_ms": tr_ms}
    log(f"[fg_spmm] spmm_window mean forward + backward: {fb_ms} ms "
        f"({fb['fwd_bwd_Medges_per_s']} Medges/s; the transposed CSR is built in each call, "
        f"{tr_ms} ms of it)")
    del xg, lib_t, calls, dx_ref, x, w, dst
    torch.cuda.empty_cache()
    return (errs, times), ([e_t, e_dx, e_r], [t_t]), fb


def random_cols(row_ptr, n_src, gen):
    """Uniform columns in [0, n_src) for the CSR's rows, sorted within each
    row: a graph with the bench graph's degrees and no locality."""
    E = int(row_ptr[-1])
    col = torch.randint(0, n_src, (E,), generator=gen, device=row_ptr.device)
    key = S.csr_edge_dst(row_ptr, E).long() * n_src + col
    return (key.sort().values % n_src).to(torch.int32)


def fg_sddmm_phase(g):
    """Kernel H at bench_sddmm_clustered's shapes (a, b [2^20, 256] f32), on
    the bench graph and on its degrees with uniform columns."""
    n, dim = g.node_count, 256
    rp, col = g.row_ptr, g.col
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    a = torch.randn(n, dim, generator=gen, device="cuda")
    b = torch.randn(n, dim, generator=gen, device="cuda")
    errs, times = [], []
    for name, cols in (("bench", col), ("random", random_cols(rp, n, gen))):
        pattern = sparse_csr(rp, cols, torch.ones(g.edge_count, device="cuda"), n)
        e, t = sddmm_times(f"{name} [{n}, {dim}] f32", (rp, cols, a, b),
                           lambda: torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0))
        t.update(launch_structure(f"[fg_sddmm] H {name}", lambda: S.csr_sddmm(rp, cols, a, b),
                                  H_KERNELS))
        lib_err = max_err(torch.sparse.sampled_addmm(pattern, a, b.t(), beta=0.0).values(),
                          S.csr_sddmm(rp, cols, a, b))
        t["library_max_abs_err"] = lib_err
        log(f"[fg_sddmm] H {name}: " + fmt_times(t) + f"; err {e['max_abs_err']} (tol "
            f"{e['tol']}); cuSPARSE sampled_addmm differs from H by {lib_err}; " + fmt_staged(t))
        errs.append(e)
        times.append(t)
        del pattern, cols
    del a, b
    torch.cuda.empty_cache()
    return errs, times


PAIRED_STEPS = 30       # timed device-memory steps of a paired run
PAIRED_HOST_STEPS = 10  # timed host-tier steps of a paired run
PAIRED_PARTS = ("steps", "store", "sweep", "spmm", "sddmm", "hetero", "rows", "agg", "apply",
                "host_apply")
OWN_PARTS = ("weighted",)  # this tree's entry points only, never run by default


def paired_times(parts=PAIRED_PARTS):
    """Kernels through entry points that every tree of the port with the row
    store has, so that this function also times another tree (run from its
    root as the module docstring says). One JSON line, by part:

    * ``steps``: PAIRED_STEPS device-memory steps and PAIRED_HOST_STEPS
      host-tier steps (:func:`timed_steps`), and the two hops of a step
      through ``csr_sample_neighbors`` (ms, device ms, kernels a hop);
    * ``store``: kernel I at ``bench_gather_sorted``'s ids as the store
      calls it, f32 and bf16, and kernel J at ``bench_gather``'s uniform
      ids (:func:`gather_times`: beside A and ``index_select``, in turns),
      each also as device time from a CUDA graph, and J and
      ``index_select`` by :func:`cuda_ms` with and without ``lead``;
    * ``sweep``: kernel I over density (:func:`sorted_sweep`);
    * ``spmm``: kernel G at the bench graph's mean and transposed (the
      backward's dx) calls, on its degrees with uniform columns, and one GAT
      head call (``bench_gat_layer``'s graph, a [2^18, 64] view with row
      stride 256, attention weights), by :func:`spmm_times`;
    * ``sddmm``: kernel H through ``csr_sddmm`` on the bench graph and on
      uniform columns, at D = 256 and at GAT's head width (views of a
      [2^20, 4, 64] tensor), 20 calls each;
    * ``hetero``: the hetero step at ``HeteroTrainConfig()``: each of one
      step's 14 A and 9 B calls checked and timed (:func:`check_gather`,
      :func:`check_scatter`: device time too), then PAIRED_STEPS timed
      steps;
    * ``rows``: the same for the device-memory step's 4 A and 3 B calls at
      ``SageTrainConfig()``, and B's masked write of ``[store]``
      (``ShardedTable.scatter`` of 2^19 uniform ids into 4,000,000 x 256);
    * ``agg``: kernel D at its calls (a)-(f) (:func:`agg_calls`), each
      checked and timed by device time, in turns (:func:`agg_times`);
    * ``apply``: the sparse apply's row update at its calls (a)-(d)
      (:func:`apply_calls`) by device time, in turns (:func:`apply_times`),
      then PAIRED_STEPS eager SAGE steps (stage split, peak memory), the
      graphed SAGE step (:func:`graphed_epoch_ms`) and PAIRED_STEPS hetero
      steps;
    * ``host_apply``: the host tier at ``SageTrainConfig()``
      (``host_cache_ratio`` HOST_CACHE_RATIO): one step's whole
      ``HostEmbedding.apply_gradients`` (its dedup and the apply's link
      work), its call of ``apply_rows_host`` (kernel L's host route) beside
      the call's link bounds, and the step's gather of the misses (kernel
      E), each by device time (``measure_chain`` of HOST_APPLY_ITERS calls,
      twice), the pinned bytes and the tier's layout, then HOST_STEPS eager
      host-tier steps (stage split, busy share);
    * ``weighted`` (named only; trees before weighted sampling lack it):
      PAIRED_STEPS uniform and weighted device-memory steps in turns
      (uniform, weighted, weighted, uniform) on the same graph, table and
      model, so that the two samplers are compared in one call; beside each,
      the host's time to enqueue one ``multilayer_sample`` (20 calls, no
      synchronisation inside) and its time by CUDA events."""
    secs = kernels.build_all()
    dev = torch.device("cuda")
    out = {"build_s": max(secs.values()), "device": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip(), "parts": list(parts)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cfg = wt.SageTrainConfig()

    def batcher(state):
        def batch():
            c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                              dtype=torch.int32)
            return c, state.labels[c.long()]
        return batch

    if "weighted" in parts:
        states = {m: wt.build_synthetic(dataclasses.replace(cfg, sample_method=m), device=dev,
                                        seed=0) for m in ("unweighted", "weighted")}
        out["weighted_turns"] = []
        for m in ("unweighted", "weighted", "weighted", "unweighted"):
            summary, launches, _ = timed_steps(f"paired {m}", states[m], batcher(states[m]),
                                               PAIRED_STEPS, 5)
            require(launches["sample_hop_weighted" if m == "weighted" else "sample_hop_uniform"]
                    == 2 * PAIRED_STEPS, f"[paired] {m} steps: launches {launches}")
            st = states[m]
            c = batcher(st)()[0]

            def sample():
                return st.graph.multilayer_sample(c, cfg.fanouts, seed=0,
                                                  weighted=m == "weighted")

            sample()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                sample()
            host_ms = (time.perf_counter() - t0) * 1e3 / 20  # enqueue only: no sync inside
            out["weighted_turns"].append({"method": m, **{k: summary[k] for k in (
                "step_median_ms", "step_p90_ms", "sample_median_ms", "busy_ms")},
                "sample_host_enqueue_ms": host_ms, "sample_cuda_ms": cuda_ms(sample)})
        del states
        torch.cuda.empty_cache()
    if "apply" in parts:
        calls = apply_calls(gen)
        out["apply"] = apply_times(calls)
        del calls
        torch.cuda.empty_cache()
        state = wt.build_synthetic(cfg, device=dev, seed=0)
        out["apply_sage_step"], _, _ = timed_steps("paired sage", state, batcher(state),
                                                   PAIRED_STEPS, 5)
        del state
        torch.cuda.empty_cache()
        out["apply_sage_step"].update(graphed_epoch_ms(cfg, gen, PAIRED_STEPS))
        log("[apply] SAGE step: eager median " + json.dumps(
            {k: out["apply_sage_step"][k] for k in ("step_median_ms", "step_p90_ms",
                                                    "stage_medians_ms", "peak_bytes",
                                                    "busy_share", "graphed_step_ms",
                                                    "graphed_peak_bytes")}))
        hcfg = wt.HeteroTrainConfig()
        hst = wt.build_hetero(hcfg, device=dev, seed=0)

        def hbatch():
            c = hst.train_ids[torch.randperm(hst.train_ids.numel(), generator=gen,
                                             device=dev)[:hcfg.batch]]
            return c, hst.labels[c.long()]

        out["apply_hetero_step"], _, _ = timed_steps("paired hetero", hst, hbatch, PAIRED_STEPS,
                                                     5, step=wt.hetero_train_step)
        del hst
        torch.cuda.empty_cache()
    if "host_apply" in parts:
        hstate = wt.build_synthetic(cfg, device=dev, seed=0, host_cache_ratio=HOST_CACHE_RATIO)
        emb = hstate.embedding
        asked, held = pinned_bytes([emb.host_table, *emb.host_slots.values()])
        rec, e_calls, l_calls = [], [], []
        real = emb.apply_gradients
        emb.apply_gradients = lambda *a, **kw: rec.append((a, kw)) or real(*a, **kw)
        with capture_kw(host_mod, "host_gather_rows", e_calls), capture_host_apply(l_calls):
            float(wt.train_step(hstate, *batcher(hstate)(), seed=0))
        del emb.apply_gradients
        a, kw = rec[0]
        (et, es), ekw = e_calls[0]  # the gather's misses
        c = l_calls[0]  # the apply's call of L's host route
        whole, gather, call = [], [], []
        for _ in range(2):
            whole.append(measure_chain(lambda i: emb.apply_gradients(*a, **kw),
                                       HOST_APPLY_ITERS) * 1e3)
            call.append(measure_chain(lambda i: host_apply_fused(c), HOST_APPLY_ITERS) * 1e3)
            gather.append(measure_chain(lambda i: H.host_gather_rows(et, es, **ekw),
                                        HOST_APPLY_ITERS) * 1e3)
        out["host_apply"] = {"whole_apply_device_ms": whole, "rows": a[0].numel(),
                             "valid": int(kw["mask"].sum()) if "mask" in kw else None,
                             "apply_call_device_ms": call, "apply_call_valid": c["vids"].numel(),
                             **host_apply_bounds(c), "miss_gather_device_ms": gather,
                             "miss_gather_rows": int(((es >= 0) & (es < et.shape[0])).sum()),
                             "pinned_bytes": asked, "pinned_held": held,
                             "layout": host_tier_layout(emb)}
        out["host_apply_step"], _, _ = timed_steps("paired host_apply", hstate, batcher(hstate),
                                                   HOST_STEPS, 5)
        log("[host_apply] host-tier step: " + json.dumps(
            {**out["host_apply"], **{k: out["host_apply_step"][k] for k in (
                "step_median_ms", "step_p90_ms", "stage_medians_ms", "busy_share")}}))
        del hstate, emb, rec, a, kw, e_calls, l_calls, c, et, es
        free_pinned()
    if "agg" in parts:
        calls, out["agg_backward"] = agg_calls(gen)
        out["agg"] = agg_times(calls)
        del calls
        torch.cuda.empty_cache()
    if "hetero" in parts:
        hcfg = wt.HeteroTrainConfig()
        hst = wt.build_hetero(hcfg, device=dev, seed=0)

        def hbatch():
            c = hst.train_ids[torch.randperm(hst.train_ids.numel(), generator=gen,
                                             device=dev)[:hcfg.batch]]
            return c, hst.labels[c.long()]

        calls, _ = captured_step(wt.hetero_train_step, hst, *hbatch())
        out["hetero_calls"] = {"A": check_gather(calls["A"])[1],
                               "B": check_scatter(calls["B"])[1]}
        del calls
        out["hetero_step"], _, _ = timed_steps("paired hetero", hst, hbatch, PAIRED_STEPS, 5,
                                               step=wt.hetero_train_step)
        del hst
        torch.cuda.empty_cache()
    if "rows" in parts:
        state = wt.build_synthetic(cfg, device=dev, seed=0)
        calls, _ = captured_step(wt.train_step, state, *batcher(state)())
        out["main_calls"] = {"A": check_gather(calls["A"])[1], "B": check_scatter(calls["B"])[1]}
        del state, calls
        torch.cuda.empty_cache()
        table = wt.ShardedTable.create(STORE_ROWS, 256, init=lambda g, shape, dt: torch.randn(
            shape, generator=g, device=dev).to(dt), generator=gen, device=dev)
        ids_u = torch.randint(0, STORE_ROWS, (STORE_BATCH,), generator=gen, device=dev,
                              dtype=torch.int32)
        rows_w = torch.randn(STORE_BATCH, 256, generator=gen, device=dev)
        bc = []
        with capture_kw(gather_mod, "scatter_rows_masked", bc):
            table = table.scatter(ids_u, rows_w, donate=True)
        out["store_B"] = check_scatter([args for args, _ in bc])[1]
        del table, ids_u, rows_w, bc
        torch.cuda.empty_cache()
    if "steps" in parts:
        state = wt.build_synthetic(cfg, device=dev, seed=0)
        out["hbm"], _, c = timed_steps("paired hbm", state, batcher(state), PAIRED_STEPS, 5)
        g = state.graph
        ml = g.multilayer_sample(c, cfg.fanouts, seed=0)
        hop_centres = (c, torch.where(ml.level_masks[1], ml.level_gids[1], 0))
        for hop, (cent, K) in enumerate(zip(hop_centres, cfg.fanouts)):
            def call():
                return wt.ops.csr_sample_neighbors(g.row_ptr, g.col, cent, K, seed=0, hop=hop)

            out[f"hop{hop}"] = {"ms": cuda_ms(call), "device_ms": graph_ms(call),
                                "kernels_seen": profiled(call, 5)[0], "shape": [cent.numel(), K]}
        del state, g, ml, c
        torch.cuda.empty_cache()
        hstate = wt.build_synthetic(cfg, device=dev, seed=0, host_cache_ratio=HOST_CACHE_RATIO)
        out["host"], _, _ = timed_steps("paired host", hstate, batcher(hstate), PAIRED_HOST_STEPS,
                                        5)
        del hstate
        free_pinned()

    n, batch_n = STORE_ROWS, STORE_BATCH
    if "store" in parts or "sweep" in parts:
        data = torch.randn(n, 256, generator=gen, device=dev)
    if "store" in parts:
        ids_s = sorted_ids(gen, n, batch_n, 0.8)
        for tag, t in (("f32", data), ("bf16", data.to(torch.bfloat16))):
            kern = lambda: G.gather_rows_sorted(t, ids_s, zero_invalid=True)  # noqa: E731
            out[f"I_bench_{tag}"] = {**gather_times(
                tag, kern, lambda: G.gather_rows_masked_plain(t, ids_s), t, ids_s),
                "device_ms": graph_ms(kern),
                "row_gather_device_ms": graph_ms(lambda: G.gather_rows(t, ids_s)),
                **sorted_stats(t, ids_s, zero_invalid=True)}
        ids_u = torch.randint(0, n, (batch_n,), generator=gen, device=dev, dtype=torch.int32)
        idx_u = ids_u.long()
        kern = lambda: G.gather_rows_masked(data, ids_u)  # noqa: E731
        require(bit_equal(kern(), G.gather_rows_masked_plain(data, ids_u)),
                "[paired] J differs from its plain version")
        out["J_bench"] = {**gather_times("uniform f32", kern,
                                         lambda: G.gather_rows_masked_plain(data, ids_u),
                                         data, ids_u),
                          "device_ms": graph_ms(kern),
                          "row_gather_device_ms": graph_ms(lambda: G.gather_rows(data, ids_u)),
                          "library_device_ms": graph_ms(
                              lambda: torch.index_select(data, 0, idx_u))}
        # J and index_select by both definitions of cuda_ms, in turns, medians
        fns = {"J": kern, "index_select": lambda: torch.index_select(data, 0, idx_u)}
        rounds = {f"{k}_ms_{tag}": [] for k in fns for tag in ("lead", "no_lead")}
        for _ in range(3):
            for k, fn in fns.items():
                for tag in ("lead", "no_lead"):
                    rounds[f"{k}_ms_{tag}"].append(cuda_ms(fn, lead=tag == "lead"))
        out["J_bench"]["cuda_ms_definitions"] = {k: statistics.median(v)
                                                 for k, v in rounds.items()}
    if "sweep" in parts:
        out["I_sweep"] = sorted_sweep({"D=256 f32": data, "D=16 f32": torch.randn(
            n, 16, generator=gen, device=dev)}, gen, n, batch_n)
    if "store" in parts or "sweep" in parts:
        del data
        torch.cuda.empty_cache()

    if "spmm" in parts or "sddmm" in parts:
        g = wt.clustered_csr(1 << 20, 16, 192)
        rp, N, E = g.row_ptr, g.node_count, g.edge_count
        ucol = random_cols(rp, N, gen)
    if "spmm" in parts:
        x = torch.randn(N, 256, generator=gen, device=dev)
        w = torch.rand(E, generator=gen, device=dev)
        t_rp, t_col, perm = S.transpose_csr(rp, g.col, N)
        inv_deg = 1.0 / (rp[1:] - rp[:-1]).clamp(min=1).float()
        mean_vals = inv_deg[S.csr_edge_dst(rp, E)]
        gg = wt.clustered_csr(1 << 18, 16, 192)
        featv = torch.randn(gg.node_count, 4, 64, generator=gen, device=dev)
        alpha = torch.rand(gg.edge_count, generator=gen, device=dev)
        cases = {"mean": ((rp, g.col, x), {"reduce": "mean"}, mean_vals),
                 "transposed": ((t_rp, t_col, x), {"edge_weight": w[perm]}, w[perm]),
                 "uniform_mean": ((rp, ucol, x), {"reduce": "mean"}, mean_vals),
                 "gat_head": ((gg.row_ptr, gg.col, featv[:, 1, :]), {"edge_weight": alpha},
                              alpha)}
        for name, (args, kw, vals) in cases.items():
            lib = sparse_csr(args[0], args[1], vals.contiguous(), args[2].shape[0])
            xs = args[2]
            _, out[f"G_{name}"] = spmm_times(name, args, kw, lambda: torch.sparse.mm(lib, xs))
            del lib
        del x, w, t_rp, t_col, perm, gg, featv, alpha
        torch.cuda.empty_cache()
    if "sddmm" in parts:
        a = torch.randn(N, 256, generator=gen, device=dev)
        b = torch.randn(N, 256, generator=gen, device=dev)
        ha, hb = a.view(N, 4, 64)[:, 1, :], b.view(N, 4, 64)[:, 2, :]
        for name, cols in (("clustered", g.col), ("random", ucol)):
            for dim, p, q in ((256, a, b), (64, ha, hb)):
                S.csr_sddmm(rp, cols, p, q)
                out[f"H_{name}_D{dim}_ms"] = cuda_ms(lambda: S.csr_sddmm(rp, cols, p, q))
    log("[paired] " + json.dumps(out))


def init_gat(layer, gen):
    """bench_gat_layer's layer with random weights: ``proj`` ~ normal with
    std 1/sqrt(fan_in), ``attn_*`` uniform within ±sqrt(6 / (H + D))."""
    with torch.no_grad():
        w = layer.proj.weight
        w.copy_(torch.randn(w.shape, generator=gen, device=w.device) / math.sqrt(w.shape[1]))
        for p in (layer.attn_src, layer.attn_dst):
            lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_((2 * torch.rand(p.shape, generator=gen, device=p.device) - 1) * lim)


def fg_gat_phase():
    """The GAT layer at bench_gat_layer's shapes: clustered_csr(2^18, 16,
    192), 4 heads of 64 over input width 256, self loop. One captured
    forward + backward (counts from 0) whose every G and H call is held
    against its plain version, then the forward and the forward + backward
    timed."""
    n, heads, dh, din = 1 << 18, 4, 64, 256
    t0 = time.perf_counter()
    g = wt.clustered_csr(n, 16, 192)
    fg = g.to_full_graph(windowed=True)
    torch.cuda.synchronize()
    require(g.edge_count == 5_111_434, f"GAT bench graph has {g.edge_count} edges")
    layer = GATConv(din, dh, num_heads=heads, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    init_gat(layer, gen)
    feats = torch.randn(n, din, generator=gen, device="cuda")
    log(f"[fg_gat] clustered_csr(2^18, 16, 192): {g.edge_count} edges, plan window {fg.window}; "
        f"layer {heads} x {dh} over {din}, built in {time.perf_counter() - t0:.2f} s")

    def fwd_bwd():
        layer.zero_grad(set_to_none=True)
        x = feats.detach().requires_grad_()
        loss = layer(x, fg).sum()
        loss.backward()
        return loss.detach(), x.grad

    g_calls, h_calls = [], []
    torch.cuda.synchronize()
    reset_launches()
    with capture_kw(S, "csr_spmm", g_calls), capture_kw(S, "csr_sddmm", h_calls):
        loss, dx = fwd_bwd()
        torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(S.CSR_SPMM.routes)
    require(launches["csr_spmm"] > 0 and launches["csr_sddmm"] > 0
            and routes.get("transposed", 0) > 0 and routes.get("forward", 0) > 0,
            f"the GAT layer did not launch G (both routes) and H: {launches} {routes}")
    require(len(g_calls) == 2 * heads and len(h_calls) == heads,
            f"GAT calls: {len(g_calls)} G, {len(h_calls)} H")
    require(bool(torch.isfinite(loss)) and bool(torch.isfinite(dx).all()), "non-finite GAT grads")
    attn = layer.attn_src.grad.abs().max().item()
    require(attn > 0, "attn_src's gradient is zero")
    errs = {"forward": [], "transposed": [], "sddmm": []}
    times = {"forward": [], "transposed": [], "sddmm": []}
    for i, (args, kw) in enumerate(g_calls):
        route = kw.get("route", "forward")
        first = not times[route]
        rp_, col_, x_ = args
        w_ = kw["edge_weight"]
        if first:  # time the first call of each route, check every call
            lib = sparse_csr(rp_, col_, w_.contiguous(), x_.shape[0])
            e, t = spmm_times(f"GAT G {route} call {i} [{x_.shape[0]}, {x_.shape[1]}] "
                              f"stride {x_.stride(0)}", args, kw,
                              lambda: torch.sparse.mm(lib, x_), iters=10)
            times[route].append(t)
            del lib
        else:
            ref = S.csr_spmm_plain(*args, reduce=kw["reduce"], edge_weight=w_)
            tol = g_tol(ref, longest_row(rp_))
            e = {"case": f"GAT G {route} call {i}",
                 "max_abs_err": max_err(S.csr_spmm(*args, **kw), ref), "tol": tol}
            require(e["max_abs_err"] <= tol, f"GAT G call {i}: {e}")
        errs[route].append(e)
    for i, args in enumerate(a for a, _ in h_calls):
        if i == 0:
            pat = sparse_csr(args[0], args[1], torch.ones(args[1].numel(), device="cuda"),
                             args[3].shape[0])
            e, t = sddmm_times(f"GAT H (attention dw) call {i} [{args[2].shape[0]}, "
                               f"{args[2].shape[1]}]", args,
                               lambda: torch.sparse.sampled_addmm(pat, args[2], args[3].t(),
                                                                  beta=0.0), iters=10)
            times["sddmm"].append(t)
            del pat
        else:
            ref = S.csr_sddmm_plain(*args)
            e = {"case": f"GAT H call {i}", "max_abs_err": max_err(S.csr_sddmm(*args), ref),
                 "tol": h_tol(ref, args[2].shape[1])}
            require(e["max_abs_err"] <= e["tol"], f"GAT H call {i}: {e}")
        errs["sddmm"].append(e)
    del g_calls, h_calls
    for route in errs:
        log(f"[fg_gat] {route}: " + json.dumps(errs[route]))
        for t in times[route]:
            log(f"[fg_gat]   {t['case']}: " + fmt_times(t)
                + "; " + (fmt_staged(t) if route == "sddmm" else fmt_g_stats(t)))

    def fwd():
        with torch.no_grad():
            layer(feats, fg)

    torch.cuda.reset_peak_memory_stats()
    f_ms = cuda_ms(fwd, 10, warmup=2)
    fb_ms = cuda_ms(fwd_bwd, 10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    E = g.edge_count
    log(f"[fg_gat] forward {f_ms} ms ({E / f_ms / 1e3} Medges/s), forward + backward over "
        f"params and features {fb_ms} ms ({E / fb_ms / 1e3} Medges/s); loss {float(loss)}, "
        f"max |d attn_src| {attn}; peak memory {peak} bytes; launches of one forward + "
        f"backward {launches}, G routes {routes}")
    profile_steps("fg_gat profile", lambda i: fwd_bwd(), fb_ms, 3)
    summary = {"fwd_ms": f_ms, "fwd_bwd_ms": fb_ms, "edges": E, "peak_bytes": peak,
               "launches": launches, "routes": routes}
    del layer, feats, fg, g
    torch.cuda.empty_cache()
    return errs, times, summary


def fg_parity():
    """Tiny SAGE, GCN and GAT full-graph models on the card and on the CPU
    from the same numpy-made graph, features and weights: logits within
    1e-5 and every gradient within 1e-4 of the largest CPU value (f32 sums
    in other orders)."""
    cfg = wt.FullGraphConfig(n_nodes=700, deg=6, width=40, dim=64, hidden=64, num_classes=4)
    errs = {}
    for mt in ("sage", "gcn", "gat"):
        c = dataclasses.replace(cfg, model_type=mt)
        cpu = wt.build_full_graph(c, device="cpu", seed=1)
        model = HomoGNN(c.dim, c.hidden, c.num_classes, model_type=mt, device="cuda")
        model.load_state_dict(cpu.model.state_dict())
        gfg = GraphStructure(cpu.graph.row_ptr.cuda(), cpu.graph.col.cuda(),
                             c.n_nodes).to_full_graph(windowed=True)
        x = cpu.embedding.table
        centers = torch.arange(0, c.n_nodes, 7, dtype=torch.int32)
        y = cpu.labels[centers.long()]
        with torch.no_grad():
            la, lb = model(x.cuda(), graph=gfg).cpu(), cpu.model(x, graph=cpu.fg)
        fa = wt.full_graph_value_and_grad(model, x.cuda(), gfg, centers.cuda(), y.cuda())
        fb = wt.full_graph_value_and_grad(cpu.model, x, cpu.fg, centers, y)
        errs[mt] = {"logits": max_err(la, lb), "loss": abs(float(fa[0]) - float(fb[0])),
                    "dx": max_err(fa[1][1].cpu(), fb[1][1])}
        require(errs[mt]["logits"] <= 1e-5 * max(1.0, lb.abs().max().item()),
                f"[fg_parity] {mt} logits {errs[mt]}")
        require(errs[mt]["loss"] <= 1e-5 * max(1.0, abs(float(fb[0]))), f"{mt} loss {errs[mt]}")
        for name, gb in [("dx", fb[1][1])] + list(fb[1][0].items()):
            ga = fa[1][1] if name == "dx" else fa[1][0][name]
            err = max_err(ga.cpu(), gb)
            errs[mt][name] = err
            require(err <= 1e-4 * max(1.0, gb.abs().max().item()),
                    f"[fg_parity] {mt} gradient {name} differs: {err}")
    log(f"[fg_parity] tiny full-graph models (700 nodes, width 64), card vs CPU: "
        + json.dumps(errs))


def check_model_calls(mt, a_calls, g_calls):
    """The A call of an evaluation (bit-equal) and every G call of it and
    of one forward + backward, against their plain versions."""
    a_err = max_err(G.gather_rows(*a_calls[0]), G.gather_rows_plain(*a_calls[0]))
    require(a_err == 0.0, f"[fg_model] {mt}: row_gather differs from its plain version")
    checks = []
    for i, (args, kw) in enumerate(g_calls):
        ref = S.csr_spmm_plain(*args, reduce=kw["reduce"], edge_weight=kw.get("edge_weight"))
        err, tol = max_err(S.csr_spmm(*args, **kw), ref), g_tol(ref, longest_row(args[0]))
        require(err <= tol, f"[fg_model] {mt} G call {i}: err {err} > tol {tol}")
        checks.append({"case": f"{mt} G {kw.get('route', 'forward')} call {i} "
                               f"{list(args[2].shape)}", "max_abs_err": err, "tol": tol})
    return checks


def fg_g_widths(mt, cfg):
    """The widths of kernel G's calls in an evaluation and one forward +
    backward of a ``FullGraphConfig`` model: a GCN layer aggregates its
    output; a SAGE layer its input, or its output rounded up to 4 where that
    is narrower (``SAGEConv._project_first``)."""
    dims = [cfg.dim] + [cfg.hidden] * (cfg.num_layers - 1) + [cfg.num_classes]
    fwd = [dout if mt == "gcn" else min(-(-dout // 4) * 4, din)
           for din, dout in zip(dims, dims[1:])]
    return fwd + fwd + fwd[::-1]


def fg_model_phase():
    """``FullGraphConfig()``: the bench graph, a device-memory Embedding of
    [2^20, 256] f32 features, a 2-layer SAGE (mean) and a 2-layer GCN. For
    each: counts from 0, ``eval_full_graph`` on FG_CENTERS centres, then
    FG_STEPS timed ``full_graph_value_and_grad`` runs, counts read."""
    cfg = wt.FullGraphConfig()
    t0 = time.perf_counter()
    st = wt.build_full_graph(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[fg_model] {cfg} built in {time.perf_counter() - t0:.2f} s: "
        f"{st.graph.edge_count} edges, plan window {st.fg.window}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    centers = torch.randperm(cfg.n_nodes, generator=gen, device="cuda")[:FG_CENTERS].to(torch.int32)
    labels = st.labels[centers.long()]
    gcn = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=cfg.num_layers,
                  model_type="gcn", device="cuda")
    gcn.reset_parameters(gen)
    x = st.embedding.table
    out = {}
    for mt, model in (("sage", st.model), ("gcn", gcn)):
        # warm-up (it builds the graph's transposed CSR once), capturing
        # every A and G call, each then held against its plain version
        a_calls, g_calls = [], []
        with capture(emb_mod, "gather_rows", a_calls), capture_kw(S, "csr_spmm", g_calls):
            wt.eval_full_graph(model, st.embedding, st.fg, centers, labels)
            wt.full_graph_value_and_grad(model, x, st.fg, centers, labels)
            torch.cuda.synchronize()
        require(len(a_calls) == 1 and len(g_calls) == 3 * cfg.num_layers,
                f"[fg_model] {mt}: {len(a_calls)} A and {len(g_calls)} G calls")
        widths = [args[2].shape[1] for args, _ in g_calls]
        require(widths == fg_g_widths(mt, cfg),
                f"[fg_model] {mt}: G over widths {widths}, not {fg_g_widths(mt, cfg)}")
        checks = check_model_calls(mt, a_calls, g_calls)
        log(f"[fg_model] {mt}: A over all {cfg.n_nodes} ids bit-equal to its plain version; "
            f"G calls of one evaluation and one forward + backward: " + json.dumps(checks))
        del a_calls, g_calls
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        e_loss, e_acc = wt.eval_full_graph(model, st.embedding, st.fg, centers, labels)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t1) * 1e3
        step_ms, host_ms, losses = [], [], []
        for _ in range(FG_STEPS):
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            ev0.record()
            loss, (grads, dx) = wt.full_graph_value_and_grad(model, x, st.fg, centers, labels)
            ev1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t1) * 1e3)
            step_ms.append(ev0.elapsed_time(ev1))
            losses.append(float(loss))
        launches = read_launches()
        routes = dict(S.CSR_SPMM.routes)
        peak = torch.cuda.max_memory_allocated()
        require(np.isfinite(float(e_loss)) and all(np.isfinite(losses)),
                f"[fg_model] {mt}: non-finite loss {float(e_loss)} {losses}")
        require(bool(torch.isfinite(dx).all()) and all(bool(torch.isfinite(v).all())
                                                       for v in grads.values()),
                f"[fg_model] {mt}: non-finite gradients")
        require(launches["row_gather"] > 0 and launches["csr_spmm"] > 0
                and routes.get("forward", 0) > 0 and routes.get("transposed", 0) > 0,
                f"[fg_model] {mt} did not launch A and G (both routes): {launches} {routes}")
        med = statistics.median(step_ms)
        log(f"[fg_model] {mt}: eval_full_graph on {FG_CENTERS} centres: loss {float(e_loss)}, "
            f"accuracy {float(e_acc)}, {eval_ms} ms (host clock)")
        log(f"[fg_model] {mt}: full_graph_value_and_grad ms (CUDA events) median {med}, "
            f"p90 {quantile(step_ms, 0.9)}, min {min(step_ms)}, max {max(step_ms)}; host clock "
            f"median {statistics.median(host_ms)}; losses {losses[:3]}; peak memory {peak} "
            f"bytes ({peak / 2**30:.2f} GiB); launches {launches}, G routes {routes}")
        profile_steps(f"fg_model {mt} profile",
                      lambda i: wt.full_graph_value_and_grad(model, x, st.fg, centers, labels),
                      med, 3)
        out[mt] = {"launches": launches, "routes": routes, "step_ms_median": med,
                   "step_ms_p90": quantile(step_ms, 0.9), "eval_ms": eval_ms, "peak_bytes": peak,
                   "checks": checks}
    del st, gcn, x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the sharded row store: kernels I (sorted-window gather) and J (masked
# gather), and kernel B's masked route
# ---------------------------------------------------------------------------


def bits(t):
    """The tensor's bits, so NaN payloads and -0 compare exactly."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def bit_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def sorted_ids(gen, n, batch, density):
    """``bench_gather_sorted``'s ids (``bench.py:178-185``): ``batch``
    sorted unique ids drawn from a span of ``batch / density`` rows at a
    random base."""
    span = int(batch / density)
    base = int(torch.randint(0, n - span, (1,), generator=gen, device="cuda"))
    pick = torch.randperm(span, generator=gen, device="cuda")[:batch]
    return torch.sort(base + pick).values.to(torch.int32)


def cold_ms(fn, arg_sets, iters=20):
    """As :func:`cuda_ms`, each call on the next of ``arg_sets`` in turn, so
    that no call finds the rows of the one before it in the 50 MB L2."""
    it = itertools.cycle(arg_sets)
    return cuda_ms(lambda: fn(*next(it)), iters)


def sorted_stats(data, slots, **kw):
    """Kernel I's own counts for one call: tiles windowed, tiles read
    directly, bytes asked of device memory (none where the tree's kernel I
    does not count)."""
    if "_stats" not in inspect.signature(G.gather_rows_sorted).parameters:
        return {}
    st = torch.zeros(3, dtype=torch.int64, device=slots.device)
    G.gather_rows_sorted(data, slots, **kw, _stats=st)
    w, d, nbytes = st.tolist()
    return {"windowed_tiles": w, "direct_tiles": d, "bytes_read": nbytes,
            "window_share": w / max(w + d, 1)}


CHOOSE_WIDTHS = ((torch.float32, 256), (torch.float32, 100), (torch.float32, 16),
                 (torch.float32, 4), (torch.bfloat16, 2))
CHOOSE_DENSITIES = (1.0, 0.9, 0.6, 0.4, 0.2, 0.1)


def choose_agreement(n_ids=8192):
    """``choose_gather_kernel``'s answer held to kernel I's own counts: at
    each width of CHOOSE_WIDTHS and density of CHOOSE_DENSITIES, ``n_ids``
    evenly spaced sorted ids at exactly that density (every tile alike) go
    through I with the same density, and every tile must take the route the
    answer names. Returns ``{"dtype dim": {density: answer}}``."""
    out = {}
    for dtype, dim in CHOOSE_WIDTHS:
        key = f"{str(dtype).split('.')[-1]} {dim}"
        out[key] = {}
        for d in CHOOSE_DENSITIES:
            answer = G.choose_gather_kernel(d, dtype, dim)
            ids = (torch.arange(n_ids, dtype=torch.float64, device="cuda") / d).floor()
            data = torch.zeros(int(ids[-1]) + 1, dim, dtype=dtype, device="cuda")
            st = sorted_stats(data, ids.to(torch.int32), density=d)
            wrong = st["direct_tiles"] if answer == "window" else st["windowed_tiles"]
            require(wrong == 0, f"[store] choose_gather_kernel({d}, {key}) = {answer!r}, but "
                    f"kernel I windowed {st['windowed_tiles']} tiles and read "
                    f"{st['direct_tiles']} directly")
            out[key][d] = answer
    return out


def gather_times(case, kernel, plain, data, slots, iters=20):
    """One store gather call timed beside its bound (each distinct valid row
    read once, each output row written once, the ids read once), its plain
    version, kernel A on the same slots and ``index_select``. The kernel, A
    and ``index_select`` are timed in turns, three rounds, and each keeps its
    median: on an H100 the first timing after the phase's set-up has read
    up to 17 % slower than the same call timed next."""
    rb = data.shape[1] * data.element_size()
    valid = slots[(slots >= 0) & (slots < data.shape[0])]
    nbytes = torch.unique(valid).numel() * rb + slots.numel() * (rb + slots.element_size())
    clipped = slots.long().clamp(0, data.shape[0] - 1)
    fns = {"ms": kernel, "row_gather_ms": lambda: G.gather_rows(data, slots),
           "library_ms": lambda: torch.index_select(data, 0, clipped)}
    rounds = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            rounds[k].append(cuda_ms(fn, iters))
    b_ms, by = bound_ms(nbytes)
    t = {"case": case, **{k: statistics.median(v) for k, v in rounds.items()},
         "plain_ms": cuda_ms(plain, 5), "bound_ms": b_ms, "bound_by": by, "rounds": rounds}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["GBps_delivered"] = slots.numel() * rb / t["ms"] / 1e6
    return t


def sorted_sweep(tables, gen, n, batch):
    """Kernel I against A and ``index_select`` over id density on each of
    ``tables`` ([n, D] by name), as the store calls I (``local_take_sorted``
    with the density), held bit-equal to its plain version: ms by CUDA
    events, warm (the same ids each call) and cold (four id sets in turn;
    D = 16's spans fit the 50 MB L2), the device ms of each from a CUDA
    graph (:func:`graph_ms`; at D = 16 the host's share of a call is
    larger than the kernel's), and I's own counts."""
    sweep = []
    for name, data in tables.items():
        rb = data.shape[1] * data.element_size()
        for d in (1.0, 0.8, 0.5, 0.2):
            sets = [sorted_ids(gen, n, batch, d) for _ in range(4)]
            sl = sets[0]
            idx = sl.long()
            require(bit_equal(gather_mod.local_take_sorted(data, sl, density=d),
                              G.gather_rows_plain(data, sl)),
                    f"[store] local_take_sorted {name} d={d} differs from its plain version")
            fns = {"I": lambda: G.gather_rows_sorted(data, sl, density=d),
                   "A": lambda: G.gather_rows(data, sl),
                   "index_select": lambda: torch.index_select(data, 0, idx)}
            r = {"table": name, "density": d, **{f"{k}_ms": cuda_ms(f) for k, f in fns.items()},
                 **{f"{k}_device_ms": graph_ms(f) for k, f in fns.items()},
                 "I_cold_ms": cold_ms(lambda s: G.gather_rows_sorted(data, s, density=d),
                                      [(s,) for s in sets]),
                 "A_cold_ms": cold_ms(lambda s: G.gather_rows(data, s), [(s,) for s in sets]),
                 "bound_ms": bound_ms(batch * (2 * rb + 4))[0],
                 **dict(zip(("tile", "window"), G.sorted_plan(rb, density=d))),
                 **sorted_stats(data, sl, density=d)}
            r.update(I_over_A=r["I_ms"] / r["A_ms"], I_over_A_cold=r["I_cold_ms"] / r["A_cold_ms"],
                     I_over_A_device=r["I_device_ms"] / r["A_device_ms"])
            sweep.append(r)
            log(f"[store] sweep {name} d={d}: I {r['I_ms']} ms, A {r['A_ms']} ms (I/A "
                f"{r['I_over_A']}), index_select {r['index_select_ms']} ms; cold I "
                f"{r['I_cold_ms']} ms, A {r['A_cold_ms']} ms (I/A {r['I_over_A_cold']}); device "
                f"I {r['I_device_ms']} ms, A {r['A_device_ms']} ms (I/A {r['I_over_A_device']}), "
                f"index_select {r['index_select_device_ms']} ms; bound {r['bound_ms']} ms; tile "
                f"{r['tile']} window {r['window']} (the launch caps it at the longest span its "
                f"rule accepts); I's counts: {r.get('windowed_tiles')} tiles windowed, "
                f"{r.get('direct_tiles')} direct, {r.get('bytes_read')} bytes read")
    return sweep


def store_parity():
    """A tiny ShardedTable on the card and on the CPU from the same numpy
    data: gather on both routes, the gather's gradient, scatter as a set
    and as an add; unique ids, so every sum has one term and all are equal."""
    rs = np.random.RandomState(31)
    arr = rs.randn(500, 40).astype(np.float32)
    ids = np.sort(np.concatenate([rs.permutation(500)[:300], [-3, -1, 500, 777]])).astype(np.int32)
    rows = rs.randn(ids.size, 40).astype(np.float32)
    res = {}
    for d in ("cuda", "cpu"):
        t = wt.ShardedTable.from_array(arr, device=d)
        i, r = torch.from_numpy(ids).to(d), torch.from_numpy(rows).to(d)
        out = {lk: t.gather(i, local_kernel=lk).cpu() for lk in ("ring", "sorted")}
        data = t.data.clone().requires_grad_()
        gather_mod.gather(data, i, plan=t.plan, local_kernel="sorted").backward(r)
        out["grad"] = data.grad.cpu()
        out["set"] = torch.from_numpy(t.scatter(i, r).to_array())
        out["add"] = torch.from_numpy(t.scatter(i, r, accumulate=True).to_array())
        res[d] = out
    for k in res["cpu"]:
        require(torch.equal(res["cuda"][k], res["cpu"][k]), f"[store] parity: {k} differs")
    log(f"[store] parity: a [500, 40] table, {ids.size} ids (4 out of range), card == CPU for "
        f"{sorted(res['cpu'])}")


def store_phase():
    """The sharded row store at the JAX benches' shapes: a 4,000,000 x 256
    f32 ShardedTable (and a bf16 one) of random rows; the counts from 0, then
    ``gather(local_kernel="sorted")`` at ``bench_gather_sorted``'s ids
    (kernel I, f32 and bf16), ``gather`` at ``bench_gather``'s (kernel J)
    and ``scatter(donate=True)`` at ``bench_scatter``'s (kernel B, masked
    route), counts read; then every call checked and timed, I swept over
    density and a narrow table, I's exactness on unsorted, duplicated and
    out-of-range ids, the add, and the tiny card-vs-CPU parity."""
    n, dim, batch = STORE_ROWS, 256, STORE_BATCH
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)

    def randn(g, shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    table = wt.ShardedTable.create(n, dim, init=randn, generator=gen)
    table16 = wt.ShardedTable.create(n, dim, "bfloat16", init=randn, generator=gen)
    ids_s = sorted_ids(gen, n, batch, 0.8)
    ids_u = torch.randint(0, n, (batch,), generator=gen, device="cuda", dtype=torch.int32)
    rows_w = torch.randn(batch, dim, generator=gen, device="cuda")
    sample = torch.randperm(n, generator=gen, device="cuda")[:65536]
    sample = sample[~torch.isin(sample, ids_u.long())]
    snap = table.data[sample].clone()
    before = table.data.clone()  # for the add's check and the scatter's timing
    torch.cuda.synchronize()
    log(f"[store] [{n}, {dim}] f32 and bf16 tables ({table.data.nbytes} + {table16.data.nbytes} "
        f"bytes) in {time.perf_counter() - t0:.2f} s")

    # the main path, counts from 0
    calls = {"I": [], "J": [], "B": []}
    torch.cuda.synchronize()
    reset_launches()
    with capture_kw(gather_mod, "gather_rows_sorted", calls["I"]), \
            capture_kw(gather_mod, "gather_rows_masked", calls["J"]), \
            capture_kw(gather_mod, "scatter_rows_masked", calls["B"]):
        out_s = table.gather(ids_s, local_kernel="sorted")
        out_s16 = table16.gather(ids_s, local_kernel="sorted")
        out_r = table.gather(ids_u)
        table = table.scatter(ids_u, rows_w, donate=True)
        torch.cuda.synchronize()
    launches = read_launches()
    routes = dict(G.ROW_SCATTER.routes)
    require(launches["sorted_gather"] == 2 and launches["row_gather_masked"] == 1
            and routes.get("masked", 0) == 1,
            f"[store] the store did not launch I, J and B (masked): {launches} {routes}")
    require([len(calls[k]) for k in "IJB"] == [2, 1, 1], f"[store] calls {calls}")

    errs, times = {"I": [], "J": [], "B": []}, {"I": [], "J": [], "B": []}
    # I on the sorted bench ids, f32 and bf16
    # (the f32 table was scattered into since; its gathers are checked on the copy before)
    for (args, kw), out, tag in zip(calls["I"], (out_s, out_s16), ("f32", "bf16")):
        data, slots = args
        src = before if tag == "f32" else data
        ref = G.gather_rows_masked_plain(src, slots)
        ok = bit_equal(G.gather_rows_sorted(src, slots, **kw), ref) and bit_equal(out, ref)
        require(ok, f"[store] sorted_gather {tag} differs from its plain version")
        errs["I"].append({"case": f"bench sorted d=0.8 {tag}", "max_abs_err": 0.0, "tol": 0.0})
        t = gather_times(f"bench sorted [{batch}] of [{n}, {dim}] {tag}",
                         lambda: G.gather_rows_sorted(data, slots, **kw),
                         lambda: G.gather_rows_masked_plain(data, slots), data, slots)
        tile, window = G.sorted_plan(dim * data.element_size())
        t.update(tile=tile, window=window, **sorted_stats(data, slots, **kw),
                 gather_ms=cuda_ms(lambda: (table if tag == "f32" else table16).gather(
                     ids_s, local_kernel="sorted")))
        times["I"].append(t)
        log(f"[store] I sorted {tag}: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
            f"{t['bound_share']} of the {t['bound_ms']} ms bound); A on the same ids "
            f"{t['row_gather_ms']} ms; plain {t['plain_ms']} ms; index_select {t['library_ms']} ms; "
            f"tile {tile}, window {window}; I's counts: {t['windowed_tiles']} tiles windowed, "
            f"{t['direct_tiles']} direct, {t['bytes_read']} bytes read; "
            f"ShardedTable.gather {t['gather_ms']} ms")
    # gather_rows_window, the windowed gather by name (kernel I), on the same sorted ids
    before_i = G.SORTED_GATHER.launches
    out_w = G.gather_rows_window(before, ids_s)
    require(G.SORTED_GATHER.launches == before_i + 1
            and bit_equal(out_w, G.gather_rows_plain(before, ids_s)),
            "[store] gather_rows_window differs from its plain version")
    del out_w
    choice = choose_agreement()
    times["I"][0].update(gather_rows_window="bit-equal", choose_gather_kernel=choice)
    log(f"[store] gather_rows_window on the {batch} sorted ids (density 0.8): one I launch, "
        f"bit-equal to its plain version; choose_gather_kernel(density, dtype, dim), each "
        f"answer agreeing with every tile of kernel I on evenly spaced ids at that density: "
        f"{choice}")
    # J on the uniform bench ids
    (data, slots), kw = calls["J"][0]
    ref = G.gather_rows_masked_plain(before, slots)
    require(bit_equal(G.gather_rows_masked(before, slots), ref) and bit_equal(out_r, ref),
            "[store] row_gather_masked differs from its plain version")
    del ref
    errs["J"].append({"case": "bench uniform", "max_abs_err": 0.0, "tol": 0.0})
    t = gather_times(f"bench uniform [{batch}] of [{n}, {dim}] f32",
                     lambda: G.gather_rows_masked(data, slots),
                     lambda: G.gather_rows_masked_plain(data, slots), data, slots)
    idx_u = slots.long()
    t.update(gather_ms=cuda_ms(lambda: table.gather(ids_u)),
             device_ms=graph_ms(lambda: G.gather_rows_masked(data, slots)),
             row_gather_device_ms=graph_ms(lambda: G.gather_rows(data, slots)),
             library_device_ms=graph_ms(lambda: torch.index_select(data, 0, idx_u)),
             tile=G.masked_tile(dim * data.element_size()))
    times["J"].append(t)
    log(f"[store] J uniform: {t['ms']} ms ({t['GBps_delivered']} GB/s delivered, "
        f"{t['bound_share']} of the {t['bound_ms']} ms bound; device {t['device_ms']} ms); A on "
        f"the same ids {t['row_gather_ms']} ms (device {t['row_gather_device_ms']}); plain "
        f"{t['plain_ms']} ms; index_select {t['library_ms']} ms (device "
        f"{t['library_device_ms']}); tiles of {t['tile']} ids; ShardedTable.gather "
        f"{t['gather_ms']} ms")
    # B (masked) on the bench scatter: every id's row is the last row aimed at it
    (data, slots, rows), kw = calls["B"][0]
    uids, inv = torch.unique(ids_u.long(), return_inverse=True)
    last = torch.zeros(uids.numel(), dtype=torch.long, device="cuda").scatter_reduce_(
        0, inv, torch.arange(batch, device="cuda"), "amax", include_self=False)
    require(bit_equal(data[uids], rows_w[last]),
            "[store] a written row is not the last row aimed at it")
    kept, krows = slots[slots >= 0].long(), rows[slots >= 0]
    require(kept.numel() == uids.numel() and bit_equal(data[kept], krows),
            "[store] row_scatter (masked) did not write each kept row whole")
    require(bit_equal(data[sample], snap), "[store] the scatter changed an untouched row")
    errs["B"].append({"case": "bench scatter", "max_abs_err": 0.0, "tol": 0.0,
                      "rows_written": uids.numel(), "untouched_rows_checked": sample.numel()})
    rb = dim * 4
    t = timings(f"bench scatter [{batch}] into [{n}, {dim}] f32",
                lambda: G.scatter_rows_masked(data, slots, rows),
                lambda: G.scatter_rows_plain(data, slots, rows),
                lambda: data.index_copy_(0, kept, krows),
                bound_ms(batch * 4 + 2 * uids.numel() * rb), plain_iters=5)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    t["scatter_ms"] = cuda_ms(lambda: table.scatter(ids_u, rows_w, donate=True))
    times["B"].append(t)
    log(f"[store] B masked scatter: {t['ms']} ms ({t['bound_share']} of the {t['bound_ms']} ms "
        f"bound, {uids.numel()} distinct rows written); plain {t['plain_ms']} ms; index_copy_ "
        f"{t['library_ms']} ms; ShardedTable.scatter (one writer per id kept first) "
        f"{t['scatter_ms']} ms")
    # the add: against a float64 sum over the touched rows
    added = dataclasses.replace(table, data=before).scatter(ids_u, rows_w, accumulate=True)
    ref = before[uids].double().index_add_(0, inv, rows_w.double())
    kmax = int(torch.bincount(inv).max())
    err = max_err(added.data[uids], ref)
    tol = (kmax + 1) * F32_EPS * max(1.0, ref.abs().max().item())
    untouched = bit_equal(added.data[sample], before[sample])
    require(err <= tol and untouched, f"[store] scatter add: err {err} > tol {tol} or "
            f"an untouched row changed ({untouched})")
    errs["B"].append({"case": "bench scatter accumulate=True (index_add_) vs float64",
                      "max_abs_err": err, "tol": tol})
    del added, before, snap, ref
    log(f"[store] scatter accumulate=True: err {err} against float64 (tol {tol}, up to {kmax} "
        "rows per id)")

    # I against A over density, and on a narrow table
    sweep = sorted_sweep({"D=256 f32": table.data, "D=16 f32": wt.ShardedTable.create(
        n, 16, init=randn, generator=gen).data}, gen, n, batch)
    # I is exact on any ids: unsorted, duplicated, out of range
    data = table.data
    cases = {"unsorted": ids_s[torch.randperm(batch, generator=gen, device="cuda")],
             "duplicated": torch.sort(ids_s[torch.randint(0, batch // 8, (batch,), generator=gen,
                                                          device="cuda")]).values,
             "out of range": torch.sort(torch.cat([ids_s[:-8], torch.tensor(
                 [-1, -7, n, n + 5, -(2**31), 2**31 - 1, 0, n - 1], dtype=torch.int32,
                 device="cuda")])).values}
    for case, sl in cases.items():
        zero = bit_equal(table.gather(sl, local_kernel="sorted"), G.gather_rows_masked_plain(data, sl))
        clip = bit_equal(gather_mod.local_take_sorted(data, sl), G.gather_rows_plain(data, sl))
        require(zero and clip, f"[store] sorted gather on {case} ids: zero {zero} clip {clip}")
        errs["I"].append({"case": f"{case} ids, zero and clip", "max_abs_err": 0.0, "tol": 0.0})
    oob = ids_u.clone()
    bad_ids = torch.tensor([-1, n, n + 9, -(2**31)], dtype=torch.int32, device="cuda")
    oob[::4096] = bad_ids[torch.arange(oob[::4096].numel(), device="cuda") % 4]
    got = table.gather(oob)
    bad = (oob < 0) | (oob >= n)
    require(bit_equal(got, G.gather_rows_masked_plain(table.data, oob)) and not got[bad].any(),
            "[store] the ring gather's out-of-range rows are not zero")
    errs["J"].append({"case": f"{int(bad.sum())} out-of-range ids give zero rows",
                      "max_abs_err": 0.0, "tol": 0.0})
    log(f"[store] exact on {sorted(cases)} ids (I, zero and clip) and zero rows for "
        f"{int(bad.sum())} out-of-range ids (J)")
    del table, table16, data, calls, out_s, out_s16, out_r, rows_w
    torch.cuda.empty_cache()
    store_parity()
    log(f"[store] phase done in {time.perf_counter() - t0:.2f} s; tables freed")
    return errs, times, sweep, launches, routes


# ---------------------------------------------------------------------------
# the weighted sampler (kernel K) and the windowed sampled aggregation (D)
# ---------------------------------------------------------------------------

WEIGHTED_ROWS = kernel_variants.BENCH_ROWS    # bench_sampling's rows (degrees 16..48)
WEIGHTED_BATCH = kernel_variants.BENCH_BATCH  # its batch
WEIGHTED_K = kernel_variants.BENCH_K          # its fanout
WEIGHTED_STEPS = 30          # timed full-width weighted steps (p90 has 3 beyond it)
KW = sampling_mod.SAMPLE_HOP_WEIGHTED


def weighted_route(route, row_ptr, col, w, pairs, centers, K, seed, hop, max_degree):
    """One ``csr_sample_neighbors`` call on the pair table or on the
    separate arrays; fails unless it launched kernel K once."""
    k0 = KW.launches
    res = wt.ops.csr_sample_neighbors(row_ptr, col, centers, K, seed=seed, hop=hop, weights=w,
                                      max_degree=max_degree,
                                      cw_blocks=pairs if route == "pairs" else None)
    require(KW.launches == k0 + 1, f"csr_sample_neighbors ({route}) did not launch K once")
    return res


def check_weighted(case, row_ptr, col, w, pairs, centers, K, seed, hop, max_degree):
    """Kernel K on both routes against its plain version on the card by the
    equality rule (``ops.sampling.weighted_near_ties``: bit for bit on every
    centre without two keys within 4 ulps near its cut), the two routes
    bit-equal; the near-tie counts printed."""
    ref = sampling_mod.csr_sample_neighbors_weighted_plain(row_ptr, col, w, centers, K, seed, hop)
    near, inside = sampling_mod.weighted_near_ties(row_ptr, col, w, centers, K, seed, hop)
    ref_f = {f: getattr(ref, f) for f in SAMPLE_FIELDS}
    out = {"case": case, "max_abs_err": 0.0, "tol": 0.0, "fields": list(SAMPLE_FIELDS),
           "centres": centers.numel(), "valid_slots": int(ref.mask.sum())}
    got = {}
    for route in ("pairs", "separate"):
        got[route] = weighted_route(route, row_ptr, col, w, pairs, centers, K, seed, hop,
                                    max_degree)
        n_near, n_differ, n_bad = sampling_mod.weighted_rule(
            {f: getattr(got[route], f) for f in SAMPLE_FIELDS}, ref_f, near, inside)
        require(n_bad == 0, f"K ({case}, {route}): {n_bad} centres break the equality rule")
        out.update({f"near_ties_{route}": n_near, f"near_ties_differing_{route}": n_differ})
    require(same_sample(got["pairs"], got["separate"]), f"K ({case}): the two routes differ")
    log(f"[weighted] {case}: K equal to its plain version on both routes by the rule; near-tie "
        f"centres {out['near_ties_pairs']}, of them differing {out['near_ties_differing_pairs']} "
        f"(pairs) / {out['near_ties_differing_separate']} (separate); routes bit-equal")
    return out, ref


def weighted_cases(gen):
    """Graphs and centres beyond the bench's: rows of degree 0, K, K + 1,
    32, 33, 64, 65, 128 and 129 (the edges of K's register tiers: one
    value a lane, two, the tier of 8, its sort widths), 256 and 257 (the
    registers' edge and the list mode's) and a hub of 2^17 edges; weights with zeros, negatives, NaNs and infinities among
    them; every centre id outside [0, n) of either sign."""
    out = []
    for K in (1, 15, 200):
        n = 20_000
        degs = torch.randint(0, 2 * K + 4, (n,), generator=gen, device="cuda")
        degs[:13] = torch.tensor([0, 0, K, K + 1, 256, 257, 1 << 17, 32, 33, 64, 65, 128, 129],
                                 device="cuda")
        row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                             torch.cumsum(degs, 0)]).to(torch.int32)
        E = int(row_ptr[-1])
        col = torch.randint(0, n, (E,), generator=gen, device="cuda", dtype=torch.int32)
        w = torch.rand(E, generator=gen, device="cuda") + 0.01
        pick = torch.rand(E, generator=gen, device="cuda")
        w[pick < 0.05] = 0.0
        w[(pick >= 0.05) & (pick < 0.07)] = -1.0
        w[(pick >= 0.07) & (pick < 0.08)] = float("nan")
        w[(pick >= 0.08) & (pick < 0.09)] = float("inf")
        centers = torch.cat([torch.arange(n, device="cuda"),
                             torch.tensor([6, 6, 3, 4, 0, -1, -7, n, n + 9, -(2**31), 2**31 - 1],
                                          device="cuda")]).to(torch.int32)
        out.append((f"K={K} degrees 0, K, K+1, 32, 33, 64, 65, 128, 129, 256, 257, hub 2^17, "
                    f"weights 0/-1/NaN/inf, out-of-range centres", (row_ptr, col, w, centers, K)))
    return out


def weighted_hop_times(case, row_ptr, col, w, pairs, centers, K, seed, hop, iters=20):
    """One K call's times: the pair table's and the separate arrays' by CUDA
    events, its device time (a CUDA graph), the plain version, and for
    reference ``torch.topk`` of the padded [B, max degree] key matrix
    (built beforehand: no single PyTorch call samples); the bound counts
    the centres, their row_ptr pairs, 8 bytes an edge of theirs and the
    outputs."""
    B = centers.numel()
    start, deg = sampling_mod._centre_rows(row_ptr, centers)
    edges = int(deg.clamp(min=0).long().sum())
    keys = sampling_mod._weighted_keys(start, deg, w, seed, centers, hop,
                                       max(int(deg.max()), 1) if B else 1)

    def call():
        return sampling_mod.sample_hop_weighted(row_ptr, None, None, centers, K, seed, hop,
                                                pairs=pairs)

    seed_t = torch.tensor(seed, dtype=torch.int64, device="cuda")

    def call_dev_seed():  # the entry train_epoch's graph launches: the seed read on the card
        return sampling_mod.sample_hop_weighted(row_ptr, None, None, centers, K, seed_t, hop,
                                                pairs=pairs)

    require(same_sample(call(), call_dev_seed()),
            f"sample_hop_weighted ({case}) with the seed on the card differs")
    nbytes = B * (4 + 8) + 8 * edges + B * K * 13 + 4 * B
    b_ms, by = bound_ms(nbytes)
    t = {"case": case, "ms": cuda_ms(call, iters), "device_ms": graph_ms(call),
         "device_seed_ms": cuda_ms(call_dev_seed, iters),
         "device_seed_device_ms": graph_ms(call_dev_seed),
         "separate_ms": cuda_ms(lambda: sampling_mod.sample_hop_weighted(
             row_ptr, col, w, centers, K, seed, hop), iters),
         "plain_ms": cuda_ms(lambda: sampling_mod.csr_sample_neighbors_weighted_plain(
             row_ptr, None, None, centers, K, seed, hop, pairs=pairs), 3, warmup=1),
         "library_ms": None, "topk_ms": cuda_ms(lambda: torch.topk(keys, min(K, keys.shape[1]),
                                                                   dim=1), iters),
         "bound_ms": b_ms, "bound_by": by, "bytes": nbytes, "edges": edges}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    log(f"[weighted] {case}: K {t['ms']} ms by CUDA events (pair table; separate arrays "
        f"{t['separate_ms']}), device {t['device_ms']} ms from a CUDA graph (the seed on the "
        f"card: {t['device_seed_ms']}, device {t['device_seed_device_ms']}), plain {t['plain_ms']} "
        f"ms, topk of the ready key matrix {t['topk_ms']} ms (reference), bound {b_ms} ms "
        f"({nbytes} bytes)")
    return t


def weighted_split(case, row_ptr, pairs, centers, K, seed, hop):
    """Where K's time goes at one hop: the probes of
    ``tools/kernel_variants.k_register_variants``, each the current source
    with one step of the register path taken out (output not kept), built
    from this checkout and timed in turns beside K, by CUDA events (median
    of three) and as device time from a CUDA graph. A probe whose
    substitution no longer matches the source is named and left out, as
    the tool leaves it out."""
    with open(os.path.join(kernels.CSRC, KW.source)) as f:
        variants, stale = kernel_variants.k_register_variants(f.read())
    probes = {k: v for k, v in variants.items() if k.startswith("probe")}
    if stale:
        log(f"[weighted] K's probes that no longer match its source, left out: {stale}")
    libs, logs = kernel_variants.build(probes) if probes else ({}, {})

    def call(lib=None):
        def run():
            with kernel_variants.launching(KW, lib) if lib else contextlib.nullcontext():
                return sampling_mod.sample_hop_weighted(row_ptr, None, None, centers, K, seed,
                                                        hop, pairs=pairs)
        return run

    t = kernel_variants.in_turns({"K": call(), **{k: call(libs[k]) for k in probes}})
    with open(os.path.splitext(kernels.library_path(os.path.join(kernels.CSRC, KW.source)))[0]
              + ".log") as f:
        regs = {"K": kernel_variants.ptxas(f.read(), "hop_weighted"),
                **{k: kernel_variants.ptxas(logs[k], "hop_weighted") for k in probes}}
    log(f"[weighted] split of K at {case} (device ms, CUDA graph; CUDA events in the JSON): "
        + ", ".join(f"{k}: {v['device_ms']}" for k, v in t.items()))
    log(f"[weighted] K's build: {json.dumps(regs['K'])}")
    return {"case": case, "times": t, "ptxas": regs, "stale": stale}


def weighted_phase():
    """``[weighted]``: kernel K at ``bench_sampling(weighted=True)``'s shape
    (``bench.py:311-375``): 2,000,000 rows of degrees
    ``RandomState(1).randint(16, 49)``, uniform columns, weights ``U[0, 1) +
    0.1``, its pair table, 65,536 centres, K = 15, seed 0, declared
    max_degree 65,536. Both routes held against the plain version by the
    equality rule, one K launch a call by its count and no other kernel by
    the profiler, timed; then the edge cases at K = 1, 15 and 200."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    row_ptr, col, w, centers = kernel_variants.weighted_bench_graph(gen)
    E = int(row_ptr[-1])
    pairs = wt.ops.interleave_col_weights(col, w)
    torch.cuda.synchronize()
    log(f"[weighted] bench graph: {WEIGHTED_ROWS} rows, {E} edges, pair table "
        f"{pairs.nbytes} bytes, built in {time.perf_counter() - t0:.2f} s")
    args = (row_ptr, col, w, pairs, centers, WEIGHTED_K, 0, 0)
    errs = [check_weighted(f"bench [{WEIGHTED_BATCH}, {WEIGHTED_K}]", *args, 65536)[0]]

    def call():
        return weighted_route("pairs", *args, 65536)

    for _ in range(3):  # a window in which the profiler recorded something
        n_kern, names = profiled(call, 5)
        if names:
            break
    require(names and n_kern <= 1 and all("hop_weighted" in k for k in names),
            f"csr_sample_neighbors (weighted) launched other kernels: {n_kern} a call, {names}")
    errs[0]["kernels_per_call"] = n_kern
    bench = weighted_hop_times(f"bench [{WEIGHTED_BATCH}, {WEIGHTED_K}]", *args)
    bench["split"] = weighted_split(bench["case"], row_ptr, pairs, centers, WEIGHTED_K, 0, 0)
    del row_ptr, col, w, pairs, args
    torch.cuda.empty_cache()
    for case, (rp, cl, wc, ce, K) in weighted_cases(gen):
        errs.append(check_weighted(case, rp, cl, wc, wt.ops.interleave_col_weights(cl, wc), ce, K,
                                   17, 1, 1 << 17)[0])
    return errs, bench


def weighted_train_phase(cfg, batch_of):
    """``[weighted_train]``: the device-memory step at
    ``SageTrainConfig(sample_method="weighted")``, full width (the graph,
    table and model of ``[train]`` plus 128 MB of weights and the 256 MB
    pair table). One captured step whose two K calls are held against the
    plain version and timed; then WEIGHTED_STEPS timed steps with the counts
    from 0: two K launches a step and no C launch, A, B and D launched, the
    loss finite."""
    wcfg = dataclasses.replace(cfg, sample_method="weighted")
    t0 = time.perf_counter()
    state = wt.build_synthetic(wcfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[weighted_train] {wcfg} built in {time.perf_counter() - t0:.2f} s: "
        f"{state.graph.edge_count} edges, weights {state.graph.edge_weight.nbytes} bytes, "
        f"pair table {state.graph.cw_blocks.nbytes} bytes")
    batch = batch_of(state)
    calls = []
    with capture_kw(sampling_mod, "sample_hop_weighted", calls):
        loss0 = float(wt.train_step(state, *batch(), seed=0))
    require(np.isfinite(loss0) and len(calls) == 2,
            f"a weighted step: loss {loss0}, {len(calls)} K calls (2 expected)")
    g = state.graph
    errs, times = [], []
    for i, (a, kw) in enumerate(calls):
        _, _, _, centers, K, seed, hop = a
        case = f"hop{i} [{centers.numel()}, {K}]"
        errs.append(check_weighted(case, g.row_ptr, g.col, g.edge_weight, g.cw_blocks, centers,
                                   K, seed, hop, g.max_degree)[0])
        times.append(weighted_hop_times(case, g.row_ptr, g.col, g.edge_weight, g.cw_blocks,
                                        centers, K, seed, hop))
    del calls
    summary, launches, c = timed_steps("weighted_train", state, batch, WEIGHTED_STEPS)
    require(launches[KW.name] == 2 * WEIGHTED_STEPS and launches["sample_hop_uniform"] == 0
            and launches["sample_cols"] == 0,
            f"the weighted sampler did not run one K launch a hop and nothing else: {launches}")
    require(all(launches[k] > 0 for k in ("row_gather", "sparse_apply", "neighbor_agg")),
            f"a kernel of the weighted step never ran: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")
    del state, g
    torch.cuda.empty_cache()
    return errs, times, launches, summary


def weighted_parity():
    """``[parity]``: a tiny weighted step three times from the same numpy
    graph, weights, table and model on the card and on the CPU: the samples
    bit-equal (no centre of these batches has a near tie), the losses within
    tolerance."""
    cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                             batch=32, fanouts=(10, 15), sample_method="weighted")
    rs = np.random.RandomState(9)
    degs = rs.randint(cfg.deg // 2, cfg.deg + cfg.deg // 2 + 1, cfg.n_nodes)
    degs[:4] = 0
    row_ptr = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    col = rs.randint(0, cfg.n_nodes, row_ptr[-1]).astype(np.int32)
    wts = (rs.rand(row_ptr[-1]) + 0.1).astype(np.float32)
    table = (rs.randn(cfg.n_nodes, cfg.dim) / np.sqrt(cfg.dim)).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, cfg.n_nodes).astype(np.int32)
    ref_model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device="cpu")
    weights = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32) / np.sqrt(v.shape[-1]))
               for k, v in ref_model.state_dict().items()}
    batches = [rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32) for _ in range(3)]

    def state(dev):
        model = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, device=dev)
        model.load_state_dict(weights)
        graph = GraphStructure(torch.from_numpy(row_ptr).to(dev), torch.from_numpy(col).to(dev),
                               cfg.n_nodes, edge_weight=torch.from_numpy(wts).to(dev))
        return wt.SageTrainState(
            cfg, graph.with_weighted_fastpath(),
            Embedding.create(cfg.n_nodes, cfg.dim, optimizer=LazyAdam(), device=dev
                             ).from_array(table),
            model, torch.optim.Adam(model.parameters(), lr=cfg.lr),
            torch.from_numpy(labels).to(dev))

    gpu, cpu = state("cuda"), state("cpu")
    tol = 1e-5  # f32 sums in other orders on the two devices, over three Adam steps
    losses = {"gpu": [], "cpu": []}
    for i, centers in enumerate(batches):
        c = torch.from_numpy(centers)
        mc = cpu.graph.multilayer_sample(c, cfg.fanouts, seed=i, weighted=True)
        for l, K in enumerate(cfg.fanouts):
            hop_centres = torch.where(mc.level_masks[l], mc.level_gids[l], 0)
            near, _ = sampling_mod.weighted_near_ties(cpu.graph.row_ptr, cpu.graph.col,
                                                      cpu.graph.edge_weight, hop_centres, K, i, l)
            require(not near.any(), f"a near tie in the weighted parity batch {i}, hop {l}")
        mg = gpu.graph.multilayer_sample(c.cuda(), cfg.fanouts, seed=i, weighted=True)
        require(torch.equal(mg.unique_gids.cpu(), mc.unique_gids)
                and all(torch.equal(a.nbr_idx.cpu(), b.nbr_idx) and torch.equal(a.mask.cpu(), b.mask)
                        for a, b in zip(mg.hops, mc.hops)),
                f"weighted samples differ between GPU and CPU (batch {i})")
        for name, st in (("gpu", gpu), ("cpu", cpu)):
            cd = c.to(st.labels.device)
            losses[name].append(float(wt.train_step(st, cd, st.labels[cd.long()], seed=i)))
    for la, lb in zip(losses["gpu"], losses["cpu"]):
        require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"weighted loss {la} (gpu) vs {lb} (cpu)")
    log(f"[parity] 3 tiny weighted steps, samples bit-equal, losses {json.dumps(losses)} "
        f"(tol {tol})")


def sampled_agg_block():
    """``bench_spmm_sampled``'s block (``bench.py:477-545``): the deepest
    hop of a (10, 15) sample of 1,024 sorted centres over
    ``clustered_csr(2,000,000, 16, 192)``, the centres drawn as the bench
    draws them, x [U, 256] f32 random, the bench's per-run windows. Returns
    (x, nbr, mask, run bounds, windows, edges)."""
    n = 2_000_000
    g = wt.clustered_csr(n, 16, 192, seed=0)
    rs = np.random.RandomState(0)  # the bench's draws after its graph's
    E = int(rs.randint(8, 32, n).sum())
    rs.randint(-96, 97, E)
    require(E == g.edge_count, f"the bench graph has {g.edge_count} edges, the draws {E}")
    centers = torch.from_numpy(np.sort(rs.choice(n, 1024, replace=False)).astype(np.int32)).cuda()
    ml = g.multilayer_sample(centers, (10, 15), seed=1)
    L = 1
    hop = ml.hops[L]
    rb = ml.run_bounds(L)
    wins = tuple(min(-(-min(b2 - b1, 1024) // 128) * 128, 1024) for b1, b2 in zip(rb, rb[1:]))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    x = torch.randn(rb[-1], 256, generator=gen, device="cuda")
    return x, hop.nbr_idx, hop.mask, rb, wins, g.edge_count


def sampled_agg_phase():
    """``[sampled_agg]``: ``padded_reduce_windowed`` at
    ``bench_spmm_sampled``'s shape (:func:`sampled_agg_block`), mean. One D
    launch, bit-equal to ``padded_reduce`` (the same kernel) and within K
    f32 ulps of the plain version; its gradient runs; timed beside
    ``padded_reduce``."""
    t0 = time.perf_counter()
    x, nbr, msk, rb, wins, n_edges = sampled_agg_block()
    U = rb[-1]
    log(f"[sampled_agg] {n_edges} edges; block [{nbr.shape[0]}, {nbr.shape[1]}] over "
        f"[{U}, 256], run bounds {rb}, windows {wins}, {int(msk.sum())} edges; built in "
        f"{time.perf_counter() - t0:.2f} s")

    def windowed():
        return wt.ops.padded_reduce_windowed(x, nbr, msk, "mean", run_bounds=rb, windows=wins)

    d0 = S.NEIGHBOR_AGG.launches
    out = windowed()
    require(S.NEIGHBOR_AGG.launches == d0 + 1, "padded_reduce_windowed did not launch D once")
    require(bit_equal(out, wt.ops.padded_reduce(x, nbr, msk, "mean")),
            "padded_reduce_windowed differs from padded_reduce")
    ref = S.neighbor_reduce_plain(x, nbr, msk, True)
    K = nbr.shape[1]
    tol = K * F32_EPS * max(1.0, ref.abs().max().item())
    err = max_err(out, ref)
    require(err <= tol, f"padded_reduce_windowed err {err} > tol {tol}")
    xg = x.clone().requires_grad_()
    wt.ops.padded_reduce_windowed(xg, nbr, msk, "mean", run_bounds=rb, windows=wins).sum().backward()
    require(bool(torch.isfinite(xg.grad).all()), "non-finite gradient of padded_reduce_windowed")

    def padded():
        return wt.ops.padded_reduce(x, nbr, msk, "mean")

    t = {"case": f"hop1 [{nbr.shape[0]}, {K}] over [{U}, 256] mean", "max_abs_err": err,
         "tol": tol, "ms": cuda_ms(windowed), "device_ms": graph_ms(windowed),
         "padded_reduce_ms": cuda_ms(padded), "padded_reduce_device_ms": graph_ms(padded),
         "plain_ms": cuda_ms(lambda: S.neighbor_reduce_plain(x, nbr, msk, True), 5),
         "bound_ms": agg_bound(x, nbr, msk)[0]}
    t["bound_share"] = t["bound_ms"] / t["device_ms"]
    log(f"[sampled_agg] padded_reduce_windowed (D): one launch, bit-equal to padded_reduce, err "
        f"{err} (tol {tol}) against the plain version; {t['ms']} ms by CUDA events, device "
        f"{t['device_ms']} ms (padded_reduce {t['padded_reduce_ms']}, device "
        f"{t['padded_reduce_device_ms']}), plain {t['plain_ms']}, bound {t['bound_ms']} "
        f"(share {t['bound_share']:.3f})")
    del x, xg
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# the sampled GCN, GAT and RGCN steps and the hetero step
# ---------------------------------------------------------------------------

NEW_STEPS = 30  # timed steps of each sampled model and of the hetero step (p90 has 3 beyond it)
SAMPLED_MODELS = (("gcn_block", {"model_type": "gcn", "degree_mode": "block"}),
                  ("gcn_true", {"model_type": "gcn", "degree_mode": "true"}),
                  ("gat", {"model_type": "gat"}),
                  ("rgcn", {"model_type": "rgcn"}))


def check_hops(calls):
    """Kernel C on each hop of a captured step: bit-equal to its plain
    version on all five ``SampleResult`` fields, timed beside it (CUDA
    events, and device time from a CUDA graph) and beside its bound."""
    errs, times = [], []
    for i, (row_ptr, col, centers, K, seed, hop) in enumerate(calls):
        def kernel():
            return sampling_mod.sample_hop_uniform(row_ptr, col, centers, K, seed, hop)

        def plain():
            return sampling_mod.csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)

        ref = plain()
        require(same_sample(kernel(), ref), f"sample_hop_uniform hop{i} differs from its plain "
                                            "version")
        B, valid = centers.numel(), int(ref.mask.sum())
        case = f"hop{i} [{B}, {K}]"
        errs.append({"case": case, "max_abs_err": 0.0, "tol": 0.0, "valid_slots": valid})
        b_ms, by = bound_ms(B * (4 + 8 + 4) + 4 * valid + B * K * 13)
        times.append({"case": case, "ms": cuda_ms(kernel), "device_ms": graph_ms(kernel),
                      "plain_ms": cuda_ms(plain, 5), "library_ms": None, "bound_ms": b_ms,
                      "bound_by": by})
    return errs, times


def captured_step(step, state, c, y):
    """One step with every A, B, C, D and L wrapper call recorded; A's calls
    come from the embedding's gather and from ``padded_gather_neighbors``
    (GAT's and RGCN's neighbour rows), L's from the apply. A tree before
    kernel L (through --paired-times) records A and B in the apply instead."""
    calls = {k: [] for k in "ABCDL"}
    apply = (capture_apply(calls["L"]) if hasattr(emb_mod, "apply_rows")
             else capture(emb_mod, "scatter_rows", calls["B"]))
    with capture(emb_mod, "gather_rows", calls["A"]), \
            capture(gather_mod, "gather_rows", calls["A"]), apply, \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]):
        loss = float(step(state, c, y, seed=0))
    require(np.isfinite(loss), f"captured step loss {loss}")
    calls["A"] = [(t.detach(), ids) for t, ids in calls["A"]]
    calls["D"] = [(x.detach(), nbr, mask, mean) for x, nbr, mask, mean in calls["D"]]
    return calls, loss


def check_new_step(tag, step, state, batch, per_step):
    """A captured step whose calls per step must be ``per_step`` and whose
    every A, B, C, D and L call is held against its plain version; then
    NEW_STEPS timed steps with the counts from 0, which must be exactly
    ``per_step`` a step for A-D and L and nothing of K or C's fetch route."""
    calls, loss0 = captured_step(step, state, *batch())
    got = {k: len(v) for k, v in calls.items()}
    require(got == per_step, f"[{tag}] calls per step {got}, expected {per_step}")
    checks = {}
    for key, kern, fn in (("A", G.ROW_GATHER, check_gather), ("B", G.ROW_SCATTER, check_scatter),
                          ("C", sampling_mod.SAMPLE_HOP, check_hops),
                          ("D", S.NEIGHBOR_AGG, check_neighbor_agg),
                          ("L", OK.SPARSE_APPLY, check_apply)):
        if calls[key]:
            checks[kern.name] = fn(calls[key])
            for e in checks[kern.name][0] + checks[kern.name][1]:
                e["case"] = f"{tag} {e['case']}"
            log(f"[check] {kern.name} ({tag}): " + json.dumps(checks[kern.name][0]))
    log(f"[{tag}] captured step: calls {got}, loss {loss0:.5f}")
    del calls
    summary, launches, c = timed_steps(tag, state, batch, NEW_STEPS, profile_steps=5, step=step)
    want = {G.ROW_GATHER.name: per_step["A"], G.ROW_SCATTER.name: per_step["B"],
            sampling_mod.SAMPLE_HOP.name: per_step["C"], S.NEIGHBOR_AGG.name: per_step["D"],
            OK.SPARSE_APPLY.name: per_step["L"]}
    want = {k: v * NEW_STEPS for k, v in want.items()}
    others = {k: v for k, v in launches.items() if k not in want and v}
    require(all(launches[k] == v for k, v in want.items()) and not others,
            f"[{tag}] launches {launches} over {NEW_STEPS} steps, expected {want} and no other")
    summary["launches"] = launches
    return summary, checks


def sampled_models_phase(cfg, batch_of):
    """``[sampled_models]``: the device-memory step at ``SageTrainConfig()``'s
    full width (the graph, table and batch of ``[train]``) for the sampled
    GCN with block and with true degrees, GAT (4 heads of 64, one head in
    the last layer) and RGCN (2 pseudo-relations): each through
    :func:`check_new_step`."""
    out, checks = {}, {}
    for tag, kw in SAMPLED_MODELS:
        mcfg = dataclasses.replace(cfg, **kw)
        t0 = time.perf_counter()
        state = wt.build_synthetic(mcfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        log(f"[sampled_models] {tag}: {mcfg} built in {time.perf_counter() - t0:.2f} s, "
            f"{state.graph.edge_count} edges")
        gcn = kw["model_type"] == "gcn"
        out[tag], checks[tag] = check_new_step(tag, wt.train_step, state, batch_of(state),
                                               {"A": 1 if gcn else 3, "B": 0, "C": 2,
                                                "D": 2 if gcn else 0, "L": 1})
        out[tag]["config"] = kw
        del state
        torch.cuda.empty_cache()
    log("[sampled_models] " + json.dumps({t: {k: v[k] for k in ("step_median_ms", "step_p90_ms",
                                                                 "peak_bytes", "busy_share")}
                                          for t, v in out.items()}))
    return out, checks


def hetero_phase():
    """``[hetero]``: ``HeteroTrainConfig()`` (the hetero example's widths,
    counts times 250: 1,000,000 papers, 375,000 authors, 50,000
    institutions) with the store trained under LazyAdam. The numpy build is
    timed on its own line; then :func:`check_new_step` on
    ``hetero_train_step`` with batches of distinct training papers."""
    cfg = wt.HeteroTrainConfig()
    t0 = time.perf_counter()
    state = wt.build_hetero(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    g = state.graph
    log(f"[hetero] {cfg}: dataset (numpy), CSR and store built in {time.perf_counter() - t0:.2f} s "
        f"(host side): {g.node_count} nodes, {g.edge_count} edges, {g.num_relations} relations, "
        f"max degree {g.max_degree}, tables " + json.dumps(
            {n: list(e.table.shape) for n, e in state.store.embeddings.items()}))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    train = state.train_ids

    def batch():
        c = train[torch.randperm(train.numel(), generator=gen, device="cuda")[:cfg.batch]]
        return c, state.labels[c.long()]

    summary, checks = check_new_step("hetero", wt.hetero_train_step, state, batch,
                                     {"A": 5, "B": 0, "C": 2, "D": 0, "L": 3})
    log_device_calls("hetero", G.ROW_GATHER, checks[G.ROW_GATHER.name][1])
    log_apply_calls("hetero", checks[OK.SPARSE_APPLY.name][1])
    for n, e in state.store.embeddings.items():
        require(bool(torch.isfinite(e.table).all()), f"[hetero] non-finite {n} table")
    del state
    torch.cuda.empty_cache()
    return summary, checks


def card_copy(cpu):
    """A card copy of a CPU ``SageTrainState``: its graph (edge types
    included), table and sparse optimizer, labels and weights, a fresh
    Adam."""
    g, c = cpu.graph, cpu.config
    model = HomoGNN(c.dim, c.hidden, c.num_classes, model_type=c.model_type,
                    num_heads=c.num_heads, num_relations=c.num_relations,
                    degree_mode=c.degree_mode, device="cuda")
    model.load_state_dict(cpu.model.state_dict())
    graph = GraphStructure(g.row_ptr.cuda(), g.col.cuda(), g.node_count, max_degree=g.max_degree,
                           edge_type=None if g.edge_type is None else g.edge_type.cuda(),
                           num_relations=g.num_relations)
    emb = Embedding.create(g.node_count, c.dim, optimizer=cpu.embedding.optimizer, device="cuda")
    return dataclasses.replace(cpu, graph=graph, embedding=emb.from_array(cpu.embedding.to_array()),
                               model=model, dense_opt=torch.optim.Adam(model.parameters(), lr=c.lr),
                               labels=cpu.labels.cuda())


def model_parity():
    """``[parity]``: three tiny steps of each sampled model and of the
    hetero step on the card and on the CPU from the same graph, table (or
    store) and weights: losses within 1e-5, and each table's change over
    the steps divided by the rate (the summed row gradients) within 1e-4
    of the largest (f32 sums in other orders). The tables train under SGD
    here: LazyAdam's step g / (|g| + 1e-8) turns f32 noise of 1e-9 on an
    element whose gradient is near 0 into a difference of up to the rate
    (the small and weighted parities hold LazyAdam on SAGE, whose row
    gradients keep clear of that)."""
    tol = 1e-5
    rs = np.random.RandomState(8)
    errs = {}

    def compare(tag, states, step, lr, batches, tables):
        before = [(a.clone(), b.clone()) for a, b in tables()]
        losses = {"gpu": [], "cpu": []}
        for i, c in enumerate(batches):
            for name, st in zip(("gpu", "cpu"), states):
                cd = c.to(st.labels.device)
                losses[name].append(float(step(st, cd, st.labels[cd.long()], seed=i)))
        for la, lb in zip(losses["gpu"], losses["cpu"]):
            require(abs(la - lb) <= tol * max(1.0, abs(lb)), f"{tag} loss {la} (gpu) vs {lb} (cpu)")
        err = 0.0
        for (a, b), (a0, b0) in zip(tables(), before):
            ga, gb = (a - a0).cpu() / lr, (b - b0) / lr
            e = max_err(ga, gb)
            require(e <= 1e-4 * max(1.0, gb.abs().max().item()),
                    f"[parity] {tag}: summed row gradients differ by {e}")
            err = max(err, e)
        errs[tag] = {"losses": losses, "summed_grad_err": err}

    for tag, kw in SAMPLED_MODELS:
        cfg = wt.SageTrainConfig(n_nodes=400, deg=16, dim=128, hidden=128, num_classes=16,
                                 batch=32, fanouts=(10, 15), **kw)
        cpu = wt.build_synthetic(cfg, device="cpu", seed=3)
        cpu.embedding = Embedding.create(cfg.n_nodes, cfg.dim, optimizer=SGD(), device="cpu"
                                         ).from_array(cpu.embedding.to_array())
        gpu = card_copy(cpu)
        batches = [torch.from_numpy(rs.randint(0, cfg.n_nodes, cfg.batch).astype(np.int32))
                   for _ in range(3)]
        compare(tag, (gpu, cpu), wt.train_step, cfg.lr, batches,
                lambda: [(gpu.embedding.table, cpu.embedding.table)])
    hcfg = wt.HeteroTrainConfig(n_paper=800, n_author=300, n_inst=40, num_classes=8, hidden=128,
                                batch=64, fanouts=(10, 10))
    hcpu, hgpu = wt.build_hetero(hcfg, device="cpu", seed=2), wt.build_hetero(hcfg, device="cuda",
                                                                             seed=2)
    hgpu.model.load_state_dict(hcpu.model.state_dict())
    for st in (hcpu, hgpu):
        st.store = HeteroFeatureStore.create(st.store.space, optimizer=SGD(),
                                             device=st.labels.device).from_arrays(
            {n: e.to_array() for n, e in hcpu.store.embeddings.items()})
    batches = [torch.from_numpy(rs.choice(hcpu.train_ids.numpy(), hcfg.batch, replace=False))
               for _ in range(3)]
    compare("hetero", (hgpu, hcpu), wt.hetero_train_step, hcfg.lr * 0.1, batches,
            lambda: [(hgpu.store.embeddings[n].table, hcpu.store.embeddings[n].table)
                     for n in hcpu.store.space.names])
    log("[parity] 3 tiny steps each of GCN (block, true), GAT, RGCN and hetero, card vs CPU: "
        + json.dumps(errs))


# ---------------------------------------------------------------------------
# the eleventh slice: file IO and checkpoints, the hot cache, the examples
# ---------------------------------------------------------------------------

IO_PARTS = 4            # part files the [io] table is written as
IO_WARM_STEPS = 3       # device-memory steps before the checkpoint
CACHE_RATIO = 0.2       # the examples' --cache-ratio default (config.py)
CACHED_STEPS = 10       # cached and uncached steps compared in [hot_cache]
HOST_CKPT_ROWS = 200_000  # rows of the host-tier embedding checkpointed in [io]


def fit_rows(directory, rows, row_bytes, copies):
    """(rows that fit twice on ``directory``'s disk, its free bytes): all
    ``rows`` when ``2 * rows * row_bytes * copies`` bytes are free, else as
    many as are."""
    free = shutil.disk_usage(directory).free
    if free >= 2 * rows * row_bytes * copies:
        return rows, free
    return int(free // (2 * row_bytes * copies)), free


def fsync_file(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def sub_embedding(emb, rows):
    """The first ``rows`` rows of ``emb`` (views of its table and slots) as
    an embedding of its own, at its step."""
    part = Embedding(rows, emb.dim, emb.optimizer, emb.dtype, emb.device, table=emb.table[:rows],
                     slots={k: v[:rows] for k, v in emb.slots.items()})
    part.step = emb.step
    return part


def copy_state(state, emb2=None):
    """A second :class:`SageTrainState` over the same graph and labels with
    copies of the model and its Adam state, and ``emb2`` or else a copy of
    the embedding (this rank's shard of it at world W)."""
    emb = state.embedding
    if emb2 is None:
        emb2 = Embedding(emb.n, emb.dim, emb.optimizer, emb.dtype, emb.device,
                         table=emb.table.clone(),
                         slots={k: v.clone() for k, v in emb.slots.items()},
                         plan=emb.plan if emb.world > 1 else None, mesh=emb.mesh,
                         axis=emb.axis)
        emb2.step = emb.step
    model2 = copy.deepcopy(state.model)
    opt2 = torch.optim.Adam(model2.parameters(), lr=state.config.lr)
    opt2.load_state_dict(copy.deepcopy(state.dense_opt.state_dict()))
    return wt.SageTrainState(state.config, state.graph, emb2, model2, opt2, state.labels)


def io_phase(state, batch, link, tmp):
    """[io]: the step's table as IO_PARTS part files by the native writer,
    read back onto the card by ``Embedding.from_filelist`` (buffered and
    O_DIRECT), bit-equal; the LazyAdam state after IO_WARM_STEPS steps
    through ``AsyncCheckpointer`` (snapshot on this thread, then the next
    step writes the table in place while the write runs), reloaded by
    ``load_embedding`` bit-equal, and the next step's loss from the
    reloaded state bit-equal to the live one's; a host-tier checkpoint on
    the card (E and L's host route) round-trips too."""
    from wholegraph_tpu_torch.io import native
    from wholegraph_tpu_torch.io.file_io import STAGING_BYTES

    cfg, emb = state.config, state.embedding
    for i in range(IO_WARM_STEPS):
        float(wt.train_step(state, *batch(), seed=100 + i))
    dim, row_bytes = emb.dim, emb.dim * emb.table.element_size()
    out = {"staging_bytes": 2 * STAGING_BYTES}

    # the table as part files, and back onto the card
    rows, free = fit_rows(tmp, emb.n, row_bytes, 1)
    table = emb.table[:rows]
    nbytes = rows * row_bytes
    cut = "" if rows == emb.n else f", CUT to {rows} rows: {free} bytes free on the disk"
    host = table.cpu()
    bounds = np.linspace(0, rows, IO_PARTS + 1).astype(np.int64)
    paths = [os.path.join(tmp, f"table_part_{k}") for k in range(IO_PARTS)]
    t0 = time.perf_counter()
    for k, p in enumerate(paths):
        native.write_rows_native(p, host[bounds[k]:bounds[k + 1]])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p in paths:
        fsync_file(p)
    fsync_s = time.perf_counter() - t0
    del host
    reads = {}
    for mode in ("buffered", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = Embedding.from_filelist(paths, dim, expected_rows=rows, direct=mode == "direct")
        torch.cuda.synchronize()
        reads[mode] = time.perf_counter() - t0
        require(bit_equal(loaded.table, table), f"[io] from_filelist ({mode}) is not the table")
        del loaded
    # the mode the direct=True read ran in: the same files opened as it opens them
    probe = np.empty(row_bytes, np.uint8)
    direct_ran = all(native.read_rows_native(paths, bounds, row_bytes, int(bounds[k]),
                                             int(bounds[k]) + 1, probe, direct=True)
                     for k in range(IO_PARTS))
    for p in paths:
        os.remove(p)
    out.update(table_rows=rows, table_bytes=nbytes, parts=IO_PARTS, write_GBps=nbytes / write_s / 1e9,
               fsync_s=fsync_s, read_GBps={k: nbytes / v / 1e9 for k, v in reads.items()},
               direct_opened_every_file=direct_ran, copy_h2d_GBps=link["h2d_GBps"])
    mode = ("O_DIRECT (every part file opened with O_DIRECT)" if direct_ran else
            "direct=True, RAN BUFFERED (the file system refused O_DIRECT)")
    log(f"[io] [{rows}, {dim}] f32 table ({nbytes} bytes) as {IO_PARTS} part files{cut}: native "
        f"write {out['write_GBps']} GB/s (then fsync {fsync_s:.3f} s); Embedding.from_filelist "
        f"onto the card, bit-equal: buffered {out['read_GBps']['buffered']} GB/s, {mode} "
        f"{out['read_GBps']['direct']} GB/s, through {2 * STAGING_BYTES} pinned staging bytes; "
        f"[link] copy_ pinned->card {link['h2d_GBps']} GB/s")

    # the LazyAdam state through AsyncCheckpointer
    rows, free = fit_rows(tmp, emb.n, row_bytes, 1 + len(emb.slots))
    ck = emb if rows == emb.n else sub_embedding(emb, rows)
    ck_bytes = rows * row_bytes * (1 + len(emb.slots))
    cut = "" if rows == emb.n else f", CUT to {rows} rows: {free} bytes free on the disk"
    saved = {"table": ck.table.clone(), **{k: v.clone() for k, v in ck.slots.items()}}
    # the model and Adam state at the save, for the next step from the reloaded table
    twin = copy_state(state, emb2=emb) if ck is emb else None
    c, y = batch()
    ckpt = wt.io.AsyncCheckpointer()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_embedding(ck, tmp, "emb")
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        live_loss = float(wt.train_step(state, c, y, seed=200))  # B writes the table meanwhile
        ckpt.wait()
        write_ms = (time.perf_counter() - t1) * 1e3
    finally:
        ckpt.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = wt.io.load_embedding(tmp, "emb")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    require(back.step == IO_WARM_STEPS and bit_equal(back.table, saved["table"])
            and all(bit_equal(back.slots[k], saved[k]) for k in ck.slots),
            "[io] the reloaded checkpoint differs from the state saved")
    require(not torch.equal(emb.table[:rows], saved["table"]), "[io] the live step changed nothing")
    next_loss = None
    if twin is not None:
        twin.embedding = back
        next_loss = float(wt.train_step(twin, c, y, seed=200))
        require(next_loss == live_loss, f"[io] next loss {next_loss} from the reloaded state, "
                                         f"{live_loss} from the live one")
    del saved, twin, back
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    out.update(checkpoint_rows=rows, checkpoint_bytes=ck_bytes, snapshot_ms=snapshot_ms,
               write_ms=write_ms, load_ms=load_ms, next_loss=next_loss, live_loss=live_loss)
    log(f"[io] checkpoint of the LazyAdam state after {IO_WARM_STEPS} steps (table, m, v: "
        f"{ck_bytes} bytes){cut}: snapshot {snapshot_ms:.1f} ms on the caller's thread, write "
        f"{write_ms:.1f} ms in the background (the next step ran meanwhile), load_embedding "
        f"{load_ms:.1f} ms; reload bit-equal; next step's loss {live_loss!r} live, "
        f"{next_loss!r} reloaded")
    out["host_tier"] = host_checkpoint(tmp)
    torch.cuda.empty_cache()
    return out


def host_checkpoint(tmp):
    """A host-tier embedding (pinned table and slots, E and L's host route) trained two
    steps on the card, saved through AsyncCheckpointer, reloaded by
    ``load_host_embedding``: host rows, slots, step and hot set bit-equal,
    and a gather of the reloaded tier equal to the live one's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    n, dim = HOST_CKPT_ROWS, 256
    he = HostEmbedding.create(n, dim, optimizer=LazyAdam(), cache_ratio=0.25)
    he.init(gen, hot_ids=np.arange(0, n, 4))
    reset_launches()
    k = min(8192, n // 2)
    for i in range(2):
        ids = torch.randperm(n, generator=gen, device="cuda")[:k].to(torch.int32)
        he.apply_gradients(ids, torch.randn(k, dim, generator=gen, device="cuda"), 0.01)
    with wt.io.AsyncCheckpointer() as ckpt:
        t0 = time.perf_counter()
        ckpt.save_host_embedding(he, tmp, "host")
        snapshot_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    back = wt.io.load_host_embedding(tmp, "host")
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    require(launches["host_gather"] > 0 and launches["sparse_apply_host"] > 0,
            f"[io] the host tier did not run E and L's host route: {launches}")
    ids = torch.randint(0, n, (65536,), generator=gen, device="cuda", dtype=torch.int32)
    require(back.step == 2 and back.hot_cap == n // 4
            and np.array_equal(back.to_array(), he.to_array())
            and all(np.array_equal(back.slot_to_array(s), he.slot_to_array(s)) for s in ("m", "v"))
            and torch.equal(back.cache_map >= 0, he.cache_map >= 0)
            and bit_equal(back.gather(ids), he.gather(ids)),
            "[io] the reloaded host tier differs from the live one")
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    nbytes = 3 * n * dim * 4
    log(f"[io] host-tier checkpoint ([{n}, {dim}] table, m, v pinned: {nbytes} bytes, "
        f"{n // 4} rows cached): snapshot {snapshot_ms:.1f} ms, load {load_ms:.1f} ms; host rows, "
        f"slots, step, hot set and a 65,536-id gather bit-equal; E {launches['host_gather']} and "
        f"L's host route {launches['sparse_apply_host']} launches")
    del he, back
    free_pinned()
    return {"bytes": nbytes, "snapshot_ms": snapshot_ms, "load_ms": load_ms}


def cached_gather_plain(table, cache, ids):
    """The plain version of ``gather_with_cache`` on one shard: the same
    lines, the kernels' plain row reads."""
    ids32 = ids.to(torch.int32)
    line = torch.searchsorted(cache.hot_ids, ids32).clamp(max=cache.size - 1)
    hit = (cache.hot_ids[line] == ids32) & cache.valid[line]
    return torch.where(hit[:, None], G.gather_rows_plain(cache.values, line),
                       G.gather_rows_plain(table, ids))


def hot_cache_phase(state, batch):
    """[hot_cache]: the top-degree CACHE_RATIO of the step's table as a hot
    cache; ``gather_with_cache`` of a step's unique ids bit-equal to its
    plain version and to ``Embedding.gather`` (two A launches), timed beside
    A on the same ids; after a cached step, the touched lines invalidated
    and served from the table; then CACHED_STEPS cached steps against as
    many uncached ones on a copy of the state, losses bit-equal (PyTorch's
    deterministic algorithms on, so ``index_add_`` sums in one order)."""
    from wholegraph_tpu_torch.embedding import (build_hot_cache, cache_hit_fraction,
                                                gather_with_cache, refresh_hot_cache)

    cfg, emb = state.config, state.embedding
    tab = emb.as_sharded_table()
    hot = hot_ids_by_degree(state.graph.row_ptr, CACHE_RATIO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = build_hot_cache(tab, hot)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    require(cache.size == max(int(emb.n * CACHE_RATIO), 1), f"[hot_cache] {cache.size} lines")
    c, y = batch()
    ml = state.graph.multilayer_sample(c, cfg.fanouts, seed=300)
    ids = ml.unique_gids[ml.unique_mask]
    reset_launches()
    out = gather_with_cache(tab, cache, ids)
    torch.cuda.synchronize()
    require(G.ROW_GATHER.launches == 2, f"[hot_cache] {G.ROW_GATHER.launches} A launches, not 2")
    require(bit_equal(out, cached_gather_plain(emb.table, cache, ids))
            and bit_equal(out, emb.gather(ids)),
            "[hot_cache] gather_with_cache differs from its plain version or the table")
    hit = cache_hit_fraction(cache, ids)
    t = {"ids": int(ids.numel()), "hit_fraction": hit, "build_ms": build_ms,
         "values_bytes": cache.values.nbytes,
         "ms": cuda_ms(lambda: gather_with_cache(tab, cache, ids)),
         "row_gather_ms": cuda_ms(lambda: G.gather_rows(emb.table, ids)),
         "plain_ms": cuda_ms(lambda: cached_gather_plain(emb.table, cache, ids)),
         "device_ms": graph_ms(lambda: gather_with_cache(tab, cache, ids)),
         "row_gather_device_ms": graph_ms(lambda: G.gather_rows(emb.table, ids))}
    log(f"[hot_cache] {cache.size} of {emb.n} rows cached by degree ({cache.values.nbytes} bytes, "
        f"built in {build_ms:.1f} ms); a step's {t['ids']} unique ids: hit fraction {hit}; "
        f"gather_with_cache bit-equal to its plain version and to Embedding.gather; "
        f"{t['ms']} ms (device {t['device_ms']}) against A alone on the same ids "
        f"{t['row_gather_ms']} ms (device {t['row_gather_device_ms']}); plain {t['plain_ms']} ms")

    # a cached step (wt.train_step through state.cache, the example's step) invalidates
    # the lines it touched; they are served from the table
    state.cache = cache
    try:
        wt.train_step(state, c, y, seed=300)
        after = state.cache
    finally:
        state.cache = None
    ids32 = ids.to(torch.int32)
    line = torch.searchsorted(cache.hot_ids, ids32).clamp(max=cache.size - 1)
    was_hot = cache.hot_ids[line] == ids32
    stale = line[was_hot]
    require(not after.valid[stale].any() and after.valid.sum() == cache.size - stale.numel(),
            "[hot_cache] the step's hot lines were not invalidated")
    require(bool((after.values[stale] != emb.table[ids[was_hot].long()]).any()),
            "[hot_cache] the step changed no cached row")
    require(bit_equal(gather_with_cache(tab, after, ids), emb.gather(ids)),
            "[hot_cache] stale lines were not served from the table")
    hit_after = cache_hit_fraction(after, ids)
    require(hit_after < hit, f"[hot_cache] hit fraction {hit_after} after invalidation")
    t.update(invalidated=int(stale.numel()), hit_fraction_after=hit_after)
    log(f"[hot_cache] after a cached step: {stale.numel()} lines invalidated, served from the "
        f"updated table (bit-equal to Embedding.gather); hit fraction {hit_after}")

    # cached steps against uncached ones on a copy of the state
    twin = copy_state(state)
    state.cache = refresh_hot_cache(tab, after)
    lc, lu = [], []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_launches()
        for i in range(CACHED_STEPS):
            c, y = batch()
            lc.append(float(wt.train_step(state, c, y, seed=400 + i)))
            lu.append(float(wt.train_step(twin, c, y, seed=400 + i)))
        launches = read_launches()
    finally:
        torch.use_deterministic_algorithms(False)
        state.cache = None
    require(lc == lu, f"[hot_cache] cached losses {lc} != uncached {lu}")
    require(launches["row_gather"] == CACHED_STEPS * (2 + 1)
            and launches["sparse_apply"] == CACHED_STEPS * 2 and launches["row_scatter"] == 0,
            f"[hot_cache] launches {launches}: A 2 a cached step and 1 an uncached, L 1 a step")
    t.update(losses=lc, table_max_abs_err=max_err(emb.table, twin.embedding.table),
             launches={k: v for k, v in launches.items() if v})
    log(f"[hot_cache] {CACHED_STEPS} cached steps against {CACHED_STEPS} uncached: losses "
        f"bit-equal {lc}; tables' max abs difference {t['table_max_abs_err']}; launches "
        f"{t['launches']}")
    del twin, after, cache
    torch.cuda.empty_cache()
    return t


EXAMPLE_KERNELS = {  # kernels each example run must launch
    "node_classification": ("row_gather", "sample_hop_uniform", "neighbor_agg"),
    "node_classification_eager": ("row_gather", "sample_hop_uniform", "neighbor_agg"),
    "node_classification_scan": ("row_gather", "sample_hop_uniform", "neighbor_agg"),
    "node_classification_eager_cache": ("row_gather", "sparse_apply", "sample_hop_uniform",
                                        "neighbor_agg"),
    "node_classification_scan_cache": ("row_gather", "sparse_apply", "sample_hop_uniform",
                                       "neighbor_agg"),
    "node_classification_gat": ("row_gather", "sparse_apply", "sample_hop_uniform", "csr_spmm"),
    "link_prediction": ("row_gather_masked", "row_gather", "sample_hop_uniform"),
    "hetero_node_classification": ("row_gather", "sample_hop_uniform"),
}


def examples_phase(tmp):
    """[examples]: each example module's ``main`` on the card, in this
    process so that the wrapper counters show which kernels each run
    launched: convert_dataset writes a synthetic dataset, node_classification
    trains SAGE on it at ``--smoke`` for 2 epochs (features by
    ``from_filelist``) and then GAT with the hot cache, a trained table,
    full-graph evaluation and a checkpoint; link_prediction and
    hetero_node_classification at ``--smoke`` for 2 epochs."""
    from wholegraph_tpu_torch.examples import (convert_dataset, hetero_node_classification,
                                               link_prediction, node_classification)

    ckpt_dir = os.path.join(tmp, "ckpt")
    runs = [
        ("convert_dataset", convert_dataset, ["--synthetic", "--nodes", "2000", "--feat-dim",
                                              "32", "--classes", "8", "--out-dir", tmp,
                                              "--name", "converted"]),
        ("node_classification", node_classification,
         ["--smoke", "--epochs", "2", "--root-dir", tmp, "--graph-name", "converted"]),
        ("node_classification_gat", node_classification,
         ["--smoke", "--epochs", "2", "--model", "gat", "--cache-type", "local_device",
          "--train-embedding", "--full-graph-eval", "--save-dir", ckpt_dir]),
        # the scanned epoch (--scan-epoch), each beside the same run eager
        ("node_classification_eager", node_classification,
         ["--smoke", "--epochs", "2", "--device", "cuda:0"]),
        ("node_classification_scan", node_classification,
         ["--smoke", "--epochs", "2", "--device", "cuda:0", "--scan-epoch"]),
        ("node_classification_eager_cache", node_classification,
         ["--smoke", "--epochs", "2", "--device", "cuda:0", "--cache-type", "local_device",
          "--train-embedding"]),
        ("node_classification_scan_cache", node_classification,
         ["--smoke", "--epochs", "2", "--device", "cuda:0", "--cache-type", "local_device",
          "--train-embedding", "--scan-epoch"]),
        ("link_prediction", link_prediction, ["--smoke", "--epochs", "2"]),
        ("hetero_node_classification", hetero_node_classification, ["--smoke", "--epochs", "2"]),
    ]
    out = {}
    for name, mod, argv in runs:
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        launches = {k: v for k, v in read_launches().items() if v}
        test = re.search(r"\[TEST\].*", text)
        epochs = [float(x) for x in re.findall(r"\[EPOCH_TIME\] ([\d.]+) s", text)]
        if name != "convert_dataset":
            require(test is not None and len(epochs) == 2 and "[TRAIN_TIME]" in text,
                    f"[examples] {name} printed no contract lines:\n{text}")
            missing = [k for k in EXAMPLE_KERNELS[name] if not launches.get(k)]
            require(not missing, f"[examples] {name} never launched {missing}: {launches}")
        losses = re.findall(r"train loss ([\d.]+)", text)
        out[name] = {"argv": argv, "seconds": secs, "epoch_s": epochs, "train_losses": losses,
                     "test": test.group(0) if test else None, "launches": launches}
        log(f"[examples] {name} {' '.join(argv)}: {secs:.2f} s; epoch times {epochs} s; "
            f"train losses {losses}; {out[name]['test']}; kernel launches {launches}")
    for kind in ("", "_cache"):  # the scanned runs beside the eager ones
        a, b = out["node_classification_eager" + kind], out["node_classification_scan" + kind]
        require(len(b["train_losses"]) == 2
                and all(np.isfinite(float(x)) for x in b["train_losses"]),
                f"[examples] the --scan-epoch run{kind} printed no finite losses")
        log(f"[examples] --scan-epoch{kind}: epoch times {b['epoch_s']} s, train losses "
            f"{b['train_losses']}, {b['test']}; eager: {a['epoch_s']} s, {a['train_losses']}, "
            f"{a['test']}")
    back = wt.io.load_embedding(ckpt_dir, "node_emb")
    require(back.step == 2 * 4 and bool(torch.isfinite(back.table).all()),
            f"[examples] the GAT run's checkpoint: step {back.step}")
    return out


# ---------------------------------------------------------------------------
# [scan_epoch]: the scanned epoch, one CUDA graph of the step replayed once a batch
# ---------------------------------------------------------------------------

SCAN_STEPS = 30          # eager and graphed steps of the SAGE cases (p90 has 3 beyond it)
SCAN_MODEL_STEPS = 10    # of the GCN, GAT and RGCN cases
SCAN_CACHE_STEPS = 10    # a cached epoch's steps: two epochs, the cache refilled in place between
SCAN_SEED = 21           # build_synthetic's seed of every copy of a case's state
SCAN_STEP0 = 500         # the first epoch's global step: step s samples with seed 500 + s
SCAN_PROFILED = 10       # replays, and eager steps, under torch.profiler
# the floor of the graphed-vs-eager bound, a share of the largest value: the eager step is
# not bit-reproducible (index_add_ sums by atomics in D's backward and in GAT's and RGCN's
# neighbour rows), so two eager runs may agree by chance and leave a zero spread
SCAN_FLOOR_REL = 1e-5
# the default-mode graphed run (the one users run and the one timed) against the
# deterministic eager run, beyond its losses: Adam turns a near-zero gradient's summation
# order into a step of up to twice the rate either way, and the rows it moves feed every
# later step, so one such flip moves the table, m, v and dense parameters by more than any
# eager spread need show. Readings (one H100 at 700 W): at most 8.7e-3 of the largest value
# (m, SAGE), 2.9e-3 (table); two default-mode eager GAT runs 8.7e-4 apart in the table
SCAN_ATOMICS_REL = 5e-2
SCAN_CASES = (  # tag, the config's changes, steps an epoch, epochs, dropout, hot cache
    ("sage", {}, SCAN_STEPS, 1, False, False),
    ("sage_weighted", {"sample_method": "weighted"}, SCAN_STEPS, 1, False, False),
    ("gcn_dropout", {"model_type": "gcn"}, SCAN_MODEL_STEPS, 1, True, False),
    ("gat", {"model_type": "gat"}, SCAN_MODEL_STEPS, 1, False, False),
    ("rgcn", {"model_type": "rgcn"}, SCAN_MODEL_STEPS, 1, False, False),
    ("sage_cache", {}, SCAN_CACHE_STEPS, 2, False, True),
)


class TimedGraph(torch.cuda.CUDAGraph):
    """``torch.cuda.CUDAGraph`` that logs its capture's host ms, the kernel
    wrappers' counts as it began (``before``) and the launches made while
    it captured (one step's calls), and counts its own replays
    (``replays``, 0 at capture)."""

    captures = []

    def capture_begin(self, *args, **kwargs):
        self._t0, self._k0, self.replays = time.perf_counter(), read_launches(), 0
        return super().capture_begin(*args, **kwargs)

    def capture_end(self):
        out = super().capture_end()
        k1 = read_launches()
        TimedGraph.captures.append({"ms": (time.perf_counter() - self._t0) * 1e3,
                                    "before": self._k0,
                                    "launches": {k: k1[k] - self._k0[k] for k in k1
                                                 if k1[k] != self._k0[k]}})
        return out

    def replay(self):
        self.replays += 1
        return super().replay()


@contextlib.contextmanager
def graph_records(state, hops, mls):
    """While a graph captures: every sampler hop's arguments and result
    (``hops``) and the step's MultilayerSample (``mls``), kept, so that
    their memory stays theirs in the graph's pool and after a replay holds
    that replay's values."""
    fns = {"C": sampling_mod.sample_hop_uniform, "K": sampling_mod.sample_hop_weighted}
    sample = state.graph.multilayer_sample

    def hop(kind):
        def rec(*args, **kwargs):
            res = fns[kind](*args, **kwargs)
            if torch.cuda.is_current_stream_capturing():
                hops.append((kind, args, kwargs, res))
            return res
        return rec

    def ml_rec(*args, **kwargs):
        ml = sample(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            mls.append(ml)
        return ml

    sampling_mod.sample_hop_uniform, sampling_mod.sample_hop_weighted = hop("C"), hop("K")
    state.graph.multilayer_sample = ml_rec
    try:
        yield
    finally:
        sampling_mod.sample_hop_uniform, sampling_mod.sample_hop_weighted = fns["C"], fns["K"]
        del state.graph.multilayer_sample


def scan_state(cfg, cache):
    """A ``SageTrainConfig`` state of SCAN_SEED with a capturable dense Adam
    (``train_epoch``'s rule) and, with ``cache``, the hot cache of the
    top-degree CACHE_RATIO of its table."""
    st = wt.build_synthetic(cfg, device="cuda", seed=SCAN_SEED)
    st.dense_opt = torch.optim.Adam(st.model.parameters(), lr=cfg.lr, capturable=True)
    if cache:
        st.cache = wt.embedding.build_hot_cache(
            st.embedding.as_sharded_table(), hot_ids_by_degree(st.graph.row_ptr, CACHE_RATIO))
    return st


def scan_quantities(st, losses):
    """The floats a graphed epoch is held to, each flattened."""
    emb = st.embedding
    return {"loss": torch.cat(losses), "table": emb.table.reshape(-1),
            **{s: emb.slots[s].reshape(-1) for s in sorted(emb.slots)},
            "dense": torch.cat([p.detach().reshape(-1) for p in st.model.parameters()])}


def check_graph_samples(tag, hops, mls, graph, cfg, c_last, seed):
    """The graph's own sample after a replay of the step with ``seed``: its
    seed tensors read ``seed``, each C hop bit-equal to
    ``csr_sample_neighbors_plain`` on its own centres and that seed, each K
    hop within ``weighted_rule`` of its plain version, and the unique ids
    and every hop bit-equal to an eager ``multilayer_sample``."""
    errs = []
    for kind, args, kwargs, res in hops:
        if kind == "C":
            row_ptr, col, centers, K, s, hop = args
            require(int(s) == seed, f"[scan_epoch] {tag}: the graph's C seed {int(s)}, not {seed}")
            ref = sampling_mod.csr_sample_neighbors_plain(row_ptr, col, centers, K, seed, hop)
            require(same_sample(res, ref),
                    f"[scan_epoch] {tag}: the graph's C hop {hop} differs from its plain version")
            errs.append({"case": f"scan {tag} hop{hop} [{centers.numel()}, {K}] in the graph",
                         "max_abs_err": 0.0, "tol": 0.0, "valid_slots": int(ref.mask.sum())})
        else:
            row_ptr, _, _, centers, K, s, hop = args
            require(int(s) == seed, f"[scan_epoch] {tag}: the graph's K seed {int(s)}, not {seed}")
            pairs = kwargs["pairs"]
            ref = sampling_mod.csr_sample_neighbors_weighted_plain(row_ptr, None, None, centers, K,
                                                                   seed, hop, pairs=pairs)
            near, inside = sampling_mod.weighted_near_ties(row_ptr, None, None, centers, K, seed,
                                                           hop, pairs=pairs)
            n_near, n_differ, bad = sampling_mod.weighted_rule(
                {f: getattr(res, f) for f in SAMPLE_FIELDS},
                {f: getattr(ref, f) for f in SAMPLE_FIELDS}, near, inside)
            require(bad == 0, f"[scan_epoch] {tag}: the graph's K hop {hop} breaks the near-tie "
                              f"rule on {bad} centres")
            errs.append({"case": f"scan {tag} hop{hop} [{centers.numel()}, {K}] in the graph",
                         "max_abs_err": 0.0, "tol": 0.0, "near_ties": n_near,
                         "near_ties_differing": n_differ})
    want = graph.multilayer_sample(c_last, cfg.fanouts, seed=seed,
                                   weighted=cfg.sample_method == "weighted",
                                   with_degrees=cfg.degree_mode == "true")
    (ml,) = mls
    require(torch.equal(ml.unique_gids, want.unique_gids)
            and torch.equal(ml.unique_mask, want.unique_mask)
            and all(torch.equal(a.nbr_idx, b.nbr_idx) and torch.equal(a.mask, b.mask)
                    for a, b in zip(ml.hops, want.hops)),
            f"[scan_epoch] {tag}: the graph's unique ids differ from the eager sample's")
    return errs


@contextlib.contextmanager
def deterministic(on):
    """PyTorch's deterministic algorithms (``index_add_`` sums in one order
    instead of by atomics) while ``on``."""
    if not on:
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def scan_case(tag, cfg, steps, epochs, dropout, cache, profile):
    """One case of ``[scan_epoch]``: five copies of one state, ``epochs``
    epochs of ``steps`` steps each (the cache refilled in place between
    epochs), on the same batches, seeds and dropout draws:

    - ``e1``: ``train_step`` with deterministic algorithms, the reference;
    - ``e2``: ``train_step`` as users run it (atomics), timed step by step:
      its distance from e1 is the eager spread;
    - ``e3``: ``train_step`` as users run it again: with e2 and e1 it gives
      the default-mode spread, the largest of the three distances;
    - ``g``: ``train_epoch`` with deterministic algorithms, held to e1
      within max(twice the eager spread, SCAN_FLOOR_REL of the largest
      value), and its bit-equality with e1 printed;
    - ``gt``: ``train_epoch`` as users run it, its graph's own samples and
      unique ids checked after each epoch's last replay, held to e1 within
      max(twice the default-mode spread, the floor, SCAN_ATOMICS_REL of the
      largest value but for the losses), timed (a later epoch of replays;
      the profiler over SCAN_PROFILED replays).

    The launches before each graphed run's capture (its warm-up steps) and
    each graph's replays are counted, and the replays held to what
    ``train_epoch`` is to make."""
    t0 = time.perf_counter()
    sts = {k: scan_state(cfg, cache) for k in ("e1", "e2", "e3", "g", "gt")}
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SCAN_SEED + 1)
    cs = [torch.randint(0, cfg.n_nodes, (steps, cfg.batch), generator=gen, device="cuda",
                        dtype=torch.int32) for _ in range(epochs + 1)]  # the last: timing only
    ys = [sts["e1"].labels[c.long()] for c in cs]
    seeds = [SCAN_STEP0 + e * steps + torch.arange(steps) for e in range(epochs + 1)]
    drop = {k: (torch.Generator(device="cuda").manual_seed(SCAN_SEED + 2) if dropout else None)
            for k in sts}
    table0 = sts["e1"].embedding.table.clone()
    base = torch.cuda.memory_allocated()

    def refill(st):
        if cache:
            wt.embedding.refresh_hot_cache_(st.embedding.as_sharded_table(), st.cache)

    # eager: e1 deterministic, e2 and e3 as run by users, e2 timed step by step
    losses = {k: [] for k in sts}
    step_ms = []
    for name in ("e1", "e2", "e3"):
        st = sts[name]
        torch.cuda.reset_peak_memory_stats()
        with deterministic(name == "e1"):
            for e in range(epochs):
                for i in range(steps):
                    ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                    ev0.record()
                    losses[name].append(wt.train_step(st, cs[e][i], ys[e][i],
                                                      seed=int(seeds[e][i]),
                                                      generator=drop[name]).reshape(1))
                    ev1.record()
                    if name == "e2":
                        ev1.synchronize()
                        step_ms.append(ev0.elapsed_time(ev1))
                refill(st)
        torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    # graphed: the first epoch warms up, captures and replays; later epochs replay
    hops, mls, epoch_ms, enqueue_ms, errs = [], [], [], [], []
    captures, warmup = {}, {}
    for name in ("g", "gt"):
        st = sts[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        k_start = read_launches()
        TimedGraph.captures.clear()
        saved, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, TimedGraph  # every graph made logs
        with deterministic(name == "g"):
            for e in range(epochs):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                h0 = time.perf_counter()
                rec = graph_records(st, hops, mls) if name == "gt" and e == 0 else None
                with rec or contextlib.nullcontext():
                    losses[name].append(wt.train.train_epoch(st, cs[e], ys[e], seeds[e],
                                                             generator=drop[name]))
                host_ms = (time.perf_counter() - h0) * 1e3
                ev1.record()
                ev1.synchronize()
                require(st.epoch_graph is not None and len(TimedGraph.captures) == 1,
                        f"[scan_epoch] {tag}: {name} epoch {e}: {len(TimedGraph.captures)} "
                        "captures, 1 expected")
                if name == "gt":
                    epoch_ms.append(ev0.elapsed_time(ev1))
                    enqueue_ms.append(host_ms)
                    errs += check_graph_samples(tag, hops, mls, st.graph, cfg, cs[e][-1],
                                                int(seeds[e][-1]))
                refill(st)
        torch.cuda.CUDAGraph = saved
        torch.cuda.synchronize()
        captures[name] = TimedGraph.captures[0]
        warmup[name] = {k: v - k_start[k] for k, v in captures[name]["before"].items()
                        if v != k_start[k]}
    graphed_peak = torch.cuda.max_memory_allocated() - base
    launches = read_launches()
    # the checks: the changed rows bit-equal, the floats within the eager spread
    touched = torch.zeros(cfg.n_nodes, dtype=torch.bool, device="cuda")
    for e in range(epochs):
        for i in range(steps):
            ml = sts["e1"].graph.multilayer_sample(cs[e][i], cfg.fanouts, seed=int(seeds[e][i]),
                                                   weighted=cfg.sample_method == "weighted")
            touched[ml.unique_gids[ml.unique_mask].long()] = True
    changed = {k: (st.embedding.table != table0).any(dim=1) for k, st in sts.items()}
    require(all(torch.equal(changed["e1"], v) for v in changed.values())
            and not (changed["e1"] & ~touched).any(),
            f"[scan_epoch] {tag}: the rows the runs changed differ, or lie outside the samples")
    if cache:
        require(all(torch.equal(st.cache.valid, sts["e1"].cache.valid)
                    and bool(st.cache.valid.all()) for st in sts.values()),
                f"[scan_epoch] {tag}: a refilled cache's lines differ from the eager run's")
    q = {k: scan_quantities(st, losses[k]) for k, st in sts.items()}
    floats = {}
    for k in q["e1"]:
        ref, top = q["e1"][k], q["e1"][k].abs().max().item()
        ee = max_err(ref, q["e2"][k])
        spread = max(ee, max_err(ref, q["e3"][k]), max_err(q["e2"][k], q["e3"][k]))
        eg, egt = max_err(ref, q["g"][k]), max_err(ref, q["gt"][k])
        floor = SCAN_FLOOR_REL * top
        tol = max(2 * ee, floor)
        tol_atomics = max(2 * spread, floor, 0.0 if k == "loss" else SCAN_ATOMICS_REL * top)
        floats[k] = {"graphed_vs_eager": eg, "bit_equal": bit_equal(ref, q["g"][k]),
                     "eager_vs_eager": ee, "floor": floor, "tol": tol,
                     "graphed_atomics_vs_eager": egt, "default_mode_spread": spread,
                     "tol_atomics": tol_atomics, "largest": top,
                     # shares of the elements beyond tol, for reading only
                     "share_beyond_tol": {r: ((q[r][k] - ref).abs() > tol).float().mean().item()
                                          for r in ("e2", "e3", "gt")}}
        require(eg <= tol, f"[scan_epoch] {tag}: {k} graphed vs eager {eg} > {tol} (twice the "
                           f"eager spread {ee}, floor {floor})")
        require(egt <= tol_atomics,
                f"[scan_epoch] {tag}: {k} default-mode graphed vs eager {egt} > {tol_atomics} "
                f"(twice the default-mode spread {spread}, floor {floor}, "
                f"{SCAN_ATOMICS_REL} of {top} but for the losses)")
    require(all(torch.isfinite(v).all() for st in q.values() for v in st.values()),
            f"[scan_epoch] {tag}: a non-finite value")
    gt = sts["gt"]
    res = {
        "config": {k: getattr(cfg, k) for k in ("model_type", "sample_method")},
        "steps": steps, "epochs": epochs, "dropout": dropout, "cache": cache,
        "build_s": build_s, "eager_step_median_ms": statistics.median(step_ms),
        "eager_step_p90_ms": quantile(step_ms, 0.9),
        "first_epoch_ms": epoch_ms[0], "capture_ms": captures["gt"]["ms"],
        "capture_ms_deterministic": captures["g"]["ms"],
        "enqueue_ms": enqueue_ms, "eager_peak_bytes": eager_peak,
        "graphed_peak_bytes": graphed_peak,
        "captured_step_launches": captures["gt"]["launches"],
        "warmup_launches": warmup["gt"], "warmup_launches_deterministic": warmup["g"],
        "launches": launches,
        "floats": floats, "checks": errs,
        "losses_first_last": [q["gt"]["loss"][0].item(), q["gt"]["loss"][-1].item()],
    }
    # a later epoch of the same S and B: every step a replay, timed
    rec = gt.epoch_graph
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    h0 = time.perf_counter()
    wt.train.train_epoch(gt, cs[epochs], ys[epochs], seeds[epochs], generator=drop["gt"])
    res["enqueue_ms"].append((time.perf_counter() - h0) * 1e3)
    ev1.record()
    ev1.synchronize()
    require(gt.epoch_graph is rec, f"[scan_epoch] {tag}: a later epoch captured again")
    res["graphed_step_ms"] = ev0.elapsed_time(ev1) / steps
    if profile:
        rec.step.zero_()
        res["graphed_profile"] = profile_steps(f"scan_epoch {tag} graphed",
                                               lambda i: rec.graph.replay(),
                                               res["graphed_step_ms"], SCAN_PROFILED)
        e2 = sts["e2"]
        res["eager_profile"] = profile_steps(
            f"scan_epoch {tag} eager",
            lambda i: wt.train_step(e2, cs[0][i], ys[0][i], seed=int(seeds[0][i])),
            res["eager_step_median_ms"], SCAN_PROFILED)
    # the replays each graph made (TimedGraph.replay counts them): the first epoch's steps
    # after the warm-up and every later epoch's steps; gt's also the timed and profiled ones
    res["replays"], res["replays_deterministic"] = (rec.graph.replays,
                                                    sts["g"].epoch_graph.graph.replays)
    want = epochs * steps - wt.train.WARMUP_STEPS
    require(res["replays_deterministic"] == want
            and res["replays"] == want + steps + (SCAN_PROFILED if profile else 0),
            f"[scan_epoch] {tag}: replays {res['replays']} (gt) and "
            f"{res['replays_deterministic']} (g), against {want} epoch replays")
    log(f"[scan_epoch] {tag}: {steps} steps x {epochs} epoch(s), dropout {dropout}, cache {cache}"
        f" (5 copies built in {build_s:.2f} s): graphed step {res['graphed_step_ms']} ms (CUDA "
        f"events over an epoch of {steps} replays / {steps}) against eager median "
        f"{res['eager_step_median_ms']} ms, p90 {res['eager_step_p90_ms']}; first epoch "
        f"{epoch_ms[0]} ms with capture {captures['gt']['ms']} ms (host); host ms to enqueue "
        f"the epochs {res['enqueue_ms']}; peak above the states {graphed_peak} bytes graphed, "
        f"{eager_peak} eager; warm-up's launches {warmup['gt']}, captured step's "
        f"{captures['gt']['launches']}, {res['replays']} replays (g: {warmup['g']}, "
        f"{res['replays_deterministic']})")
    log(f"[scan_epoch] {tag}: floats (deterministic graphed vs deterministic eager, beside the "
        f"eager spread; the default-mode graphed run vs the deterministic eager one, beside "
        f"the default-mode spread) " + json.dumps(floats))
    del sts, gt, rec, table0, hops, mls, q
    torch.cuda.empty_cache()
    return res


def scan_epoch_phase(cfg, smi):
    """``[scan_epoch]``: ``train.train_epoch`` at ``SageTrainConfig()``'s
    full width (2,000,000 nodes, a [2,000,000, 256] f32 table under
    LazyAdam, width 256, batch 1,024, fanouts (10, 15); nothing cut) against
    ``train_step``, case by case (SCAN_CASES), on five copies of one state
    (:func:`scan_case`). Fails unless, after a replay, the graph's own
    sample is its kernels' plain version's (C bit-equal; K within the
    near-tie rule) and its unique ids and the changed rows are the eager
    run's bit for bit, the losses, table, LazyAdam m and v and dense
    parameters of the graphed epoch lie within max(twice the eager spread,
    SCAN_FLOOR_REL of the largest value) of the eager epoch's (both with
    deterministic algorithms: by atomics, Adam turns the summation order's
    rounding into steps of up to twice the rate on near-zero gradients, in
    either run), those of the default-mode graphed epoch (the timed one)
    within max(twice the default-mode eager spread, that floor,
    SCAN_ATOMICS_REL of the largest value but for the losses) of the same
    reference, each graph's replays are the count ``train_epoch`` is to
    make, and C or K, A, B (and D for SAGE and GCN) ran in the
    captured step; prints the
    graphed and eager step times, the capture, the host's enqueue, the
    device busy share over SCAN_PROFILED replays beside the eager step's
    (SAGE cases), and the peak memory of each."""
    out = {}
    for tag, kw, steps, epochs, dropout, cache in SCAN_CASES:
        ccfg = dataclasses.replace(cfg, **kw)
        out[tag] = scan_case(tag, ccfg, steps, epochs, dropout, cache,
                             profile=tag in ("sage", "sage_weighted"))
        got = out[tag]["captured_step_launches"]
        sampler = KW.name if ccfg.sample_method == "weighted" else sampling_mod.SAMPLE_HOP.name
        want = {sampler: 2, OK.SPARSE_APPLY.name: 1, G.ROW_SCATTER.name: None}
        if ccfg.model_type in ("sage", "gcn"):
            want[S.NEIGHBOR_AGG.name] = 2
        require(all(got.get(k) == v for k, v in want.items()) and got.get(G.ROW_GATHER.name),
                f"[scan_epoch] {tag}: the captured step launched {got}, expected {want} and A")
    log(f"[scan_epoch] on {smi}: " + json.dumps(
        {t: {k: v[k] for k in ("graphed_step_ms", "eager_step_median_ms", "eager_step_p90_ms",
                               "capture_ms", "enqueue_ms", "graphed_peak_bytes",
                               "eager_peak_bytes")} for t, v in out.items()}))
    return out


# ---------------------------------------------------------------------------
# [world]: the store, its exchange and the sampled step at world 4 on one card
# ---------------------------------------------------------------------------

WORLD = 4                 # ranks, each a process, all on card 0
WORLD_STEPS = 5           # steps checked against world 1, under SGD and then LazyAdam; the epoch's
WORLD_TIMED = 5           # timed world-4 steps (LazyAdam, the main path's optimizer)
WORLD_CHECK_IDS = 32768   # touched rows of the table compared with world 1
WORLD_SEED = 11           # build_synthetic's seed on both sides
STORE_SEED = 12           # the store check's random 2,000,000 x 256 table
# the parts of one exchange gather, as ops.gather marks them, and the unmarked call
WORLD_SPLIT_PARTS = ("bucket", "ids_out", "serve", "rows_back", "unpermute", "remaining",
                     "gather_call")
# (A left the world-4 step with the apply's reads: its gather is the exchange's, J and B)
WORLD_PATH_KERNELS = ("row_scatter", "sample_hop_uniform", "neighbor_agg", "row_gather_masked",
                      "sparse_apply")
# the table's SGD rate in the checked SGD steps: the row gradients of the global mean loss
# over 4,096 centres are about 1e-8 to 1e-5, so at the step's 1e-3 their moves would lie
# below the f32 rounding of the table's values; at 100 a move is hundreds of ulps
WORLD_SGD_LR = 100.0
# tolerances of the world-4 step against world 1 (stated; the run prints what it measured):
# losses rtol 1e-5 (f32 sums of the loss and matmuls of another height); dense parameters
# 1e-4 (Adam at lr 1e-3 moves one by about lr a step); the table under SGD: its change over
# WORLD_SGD_LR, each element's summed row gradient (summed in another order across ranks),
# within grad_rel of itself plus grad_abs of the largest one (sums that cancel) plus
# sgd_ulps f32 ulps of its own row value over the rate (the rounding of base - lr g on
# each side), and a gradient scaled by (W - 1) / W must fail that on at least
# sgd_sensitivity of the touched elements; under LazyAdam, 4e-4 = 0.4 lr, about 3 times
# the 1.28e-4 measured on one H100 at 700 W, with at most 1e-4 of the elements
# beyond 1e-6 (9.4e-6 measured there)
WORLD_TOL = {"loss_rtol": 1e-5, "dense_atol": 1e-4, "grad_rel": 1e-4, "grad_abs": 1e-5,
             "sgd_ulps": 2, "sgd_sensitivity": 0.5, "lazy_atol": 4e-4, "lazy_share": 1e-4}


# the world-4 epoch against its eager steps: bit for bit under deterministic algorithms, or,
# where an op has no deterministic form (named by PyTorch's warning), within WORLD_TOL's
# LazyAdam bounds (losses loss_rtol, dense parameters dense_atol, table and slots lazy_atol)
EPOCH_PARTS = ("table", "m", "v")


def world_config(cfg, opt):
    """SageTrainConfig of the checked steps under ``opt`` (the table's SGD at WORLD_SGD_LR)."""
    lr = WORLD_SGD_LR if opt == "sgd" else None
    return dataclasses.replace(cfg, embedding_optimizer=opt, embedding_lr=lr)


def world_centers(cfg, steps, seed):
    """Each step's WORLD x batch distinct centres (a shuffled epoch's), [steps, WORLD, B]."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(cfg.n_nodes, generator=g)[:WORLD * cfg.batch]
                        .view(WORLD, -1) for _ in range(steps)]).int()


def table_rows(emb, ids):
    """Rows of a world-1 embedding's table at ``ids`` (device memory or the
    host tier), on the CPU."""
    if isinstance(emb, HostEmbedding):
        torch.cuda.synchronize()
        return emb.host_table[ids.cpu()]
    return emb.table[ids].cpu()


def pick_ids(touched, n_nodes, dev):
    """WORLD_CHECK_IDS ids, sorted: touched ones and 1,024 untouched."""
    keep = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    keep[touched] = False
    untouched = torch.nonzero(keep)[:, 0]
    g = torch.Generator(device=dev).manual_seed(3)
    pick = torch.cat([touched[torch.randperm(touched.numel(), generator=g, device=dev)
                              [:WORLD_CHECK_IDS - 1024]],
                      untouched[torch.randperm(untouched.numel(), generator=g, device=dev)[:1024]]])
    return pick.sort().values


def world_state(cfg, opt, dev, mesh=None, host_cache_ratio=None):
    """``build_synthetic(seed=WORLD_SEED)`` for the checked steps under
    ``opt``; under SGD the dense parameters run under SGD too, on both
    sides of a comparison: Adam's first steps move a parameter whose
    gradient is near zero by about its rate whatever that gradient's size,
    so the worlds' dense parameters would drift apart by more than their
    sums' rounding and feed that drift into every row's gradient, which
    WORLD_TOL's SGD bound does not model."""
    st = wt.build_synthetic(world_config(cfg, opt), device=dev, seed=WORLD_SEED,
                            host_cache_ratio=host_cache_ratio, mesh=mesh)
    if opt == "sgd":
        st.dense_opt = torch.optim.SGD(st.model.parameters(), lr=cfg.lr)
    return st


def world1_reference(cfg, centers, opt, first, host_cache_ratio=None):
    """The port's world-1 step on each step's concatenated WORLD x batch
    centres, WORLD_STEPS steps (``centers[first:]``, sampler seeds from
    ``first``) from :func:`world_state`, the table in device memory or,
    with ``host_cache_ratio``, in the host tier: the losses,
    WORLD_CHECK_IDS of the touched ids (and 1,024 untouched), the table's
    rows there before and after, and the dense parameters."""
    dev = torch.device("cuda")
    st = world_state(cfg, opt, dev, host_cache_ratio=host_cache_ratio)
    every = torch.arange(cfg.n_nodes, device=dev)
    base = table_rows(st.embedding, every).clone()
    losses, touched = [], []
    for i in range(first, first + WORLD_STEPS):
        c = centers[i].reshape(-1).to(dev)
        ml = st.graph.multilayer_sample(c, cfg.fanouts, seed=i)
        touched.append(ml.unique_gids[ml.unique_mask].long())
        losses.append(float(wt.train_step(st, c, st.labels[c.long()], seed=i)))
    touched = torch.unique(torch.cat(touched))
    ids = pick_ids(touched, cfg.n_nodes, dev)
    out = {"losses": losses, "ids": ids.int().cpu(), "touched": touched.numel(),
           "base": base[ids.cpu()], "rows": table_rows(st.embedding, ids),
           "dense": {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}}
    del st, base
    free_pinned()
    return out


def synced_ms(fn, iters=5):
    """Median wall ms of ``fn`` with the card synchronised around each call
    (the gloo route waits on the host, so the wall clock is its time); every
    rank calls it the same number of times."""
    ts = []
    for _ in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts[1:])


def world_store(rank, mesh, ids_all, dev):
    """The store at SageTrainConfig()'s width on this rank: each method,
    plan and option against kernel J on a full replica (the world-1 answer),
    a fully skewed batch, and the scatter's set and add against the same
    writes on the replica."""
    from wholegraph_tpu_torch.memory.sharded_table import local_rows
    from wholegraph_tpu_torch.parallel import create_hierarchy_mesh

    cfg = wt.SageTrainConfig()
    n, D = cfg.n_nodes, cfg.dim
    full = torch.randn((n, D), generator=torch.Generator(device=dev).manual_seed(STORE_SEED),
                       device=dev)
    mine = ids_all[rank]
    want = G.gather_rows_masked(full, mine)  # world 1: kernel J on the whole table
    skew = mine % (n // WORLD)  # every id on shard 0 of the equal plan
    want_skew = G.gather_rows_masked(full, skew)
    hmesh = create_hierarchy_mesh(2, 2)
    plans = {"equal": wt.PartitionPlan.equal(n, WORLD),
             "custom": wt.PartitionPlan.custom((300_000, 700_000, 600_000, 400_000)),
             "round_robin": wt.PartitionPlan.round_robin(n, WORLD, 1024)}
    checks, drops = {}, {}
    reset_launches()
    for pname, plan in plans.items():
        t = wt.ShardedTable(local_rows(plan, rank, full), plan, "device", dev, mesh)
        for m in ("a2a", "a2a_capped", "allgather", "ragged"):
            got = t.gather(mine, method=m)
            if m == "a2a_capped":  # dropped ids are zero rows, the others right
                same = (got == want).all(1)
                checks[pname, m] = bool((same | (got == 0).all(1)).all())
                drops[pname] = int((~same).sum())
            else:
                checks[pname, m] = bool(torch.equal(got, want))
            if pname == "equal":
                kw = dict(dedup=True, local_kernel="sorted")
                got = t.gather(mine, method=m, **kw)
                checks[pname, m, "dedup_sorted"] = bool(
                    torch.equal(got, want) if m != "a2a_capped"
                    else ((got == want).all(1) | (got == 0).all(1)).all())
        if pname == "equal":
            h = wt.ShardedTable(t.data, plan, "device", dev, hmesh, ("node", "device"))
            checks[pname, "hierarchy"] = bool(torch.equal(h.gather(mine, method="hierarchy"),
                                                          want))
            checks[pname, "hierarchy", "dedup_sorted"] = bool(torch.equal(
                h.gather(mine, method="hierarchy", dedup=True, local_kernel="sorted"), want))
            rounds = {}  # hierarchy: both stages' rounds, at capacity factor 0.5
            for m, cf in (("a2a", 2.0), ("hierarchy", 0.5)):
                tab = h if m == "hierarchy" else t
                gather_mod.EXCHANGE_STATS["rounds"] = 0
                checks[pname, "full_skew", m] = bool(torch.equal(
                    tab.gather(skew, method=m, capacity_factor=cf), want_skew))
                rounds[m] = gather_mod.EXCHANGE_STATS["rounds"]
            overflow = int(gather_mod.gather_overflow(mine, plan=plan, mesh=mesh)[0])
        if pname != "custom":  # the scatter: set on ids unique over the ranks, add on the batches
            g = torch.Generator(device=dev).manual_seed(13)
            perm = torch.randperm(n, generator=g, device=dev)[:WORLD * mine.numel()]
            perm = perm.view(WORLD, -1)
            vals = torch.randint(-3, 4, (WORLD, mine.numel(), D), generator=g,
                                 device=dev).float()
            ref = full.clone()
            ref[perm.reshape(-1)] = vals.reshape(-1, D)
            got = t.scatter(perm[rank], vals[rank])
            checks[pname, "scatter_set"] = bool(torch.equal(got.data, local_rows(plan, rank, ref)))
            del ref, got
            ok = ids_all < n
            ref = torch.zeros_like(full).index_add_(0, ids_all[ok].long(), vals[ok])
            z = wt.ShardedTable.create(n, D, plan=plan, device=dev, mesh=mesh)
            got = z.scatter(mine, vals[rank], accumulate=True, donate=True)
            checks[pname, "scatter_add"] = bool(torch.equal(got.data, local_rows(plan, rank, ref)))
            del ref, got, z
        del t
    launches = read_launches()
    del full
    torch.cuda.empty_cache()
    return {"checks": {" ".join(k): v for k, v in checks.items()}, "drops": drops,
            "overflow": overflow, "full_skew_rounds": rounds, "launches": launches}


def marked_split(fn, module, hook, iters):
    """``iters`` calls of ``fn`` (after one untimed) with ``module.<hook>``
    set to a timer that synchronises the card at every mark it hears and
    adds the wall ms since the previous mark to that part: ``({part: median
    ms over the calls}, [each call's wall ms])``. Every rank calls it the
    same number of times."""
    fn()
    parts, totals = {}, []
    for _ in range(iters):
        call = {}
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        start = t[0]

        def mark(part, t=t, call=call):
            torch.cuda.synchronize()
            now = time.perf_counter()
            call[part] = call.get(part, 0.0) + (now - t[0]) * 1e3
            t[0] = now
        setattr(module, hook, mark)
        try:
            fn()
        finally:
            setattr(module, hook, None)
        torch.cuda.synchronize()
        totals.append((time.perf_counter() - start) * 1e3)
        for k, v in call.items():
            parts.setdefault(k, []).append(v)
    return {k: statistics.median(v) for k, v in parts.items()}, totals


def world_exchange_split(emb, ids, iters=5):
    """The exchange gather of the step's unique ids, split by the parts that
    ``ops.gather`` marks inside the call (bucket, ids out, serve, rows back,
    un-permute, the all_reduce of the ids left): each part's wall ms with
    the card synchronised at every mark, summed over the call's rounds, the
    median of ``iters`` calls after one unmarked; then the whole call
    unmarked. Every rank calls it the same number of times."""
    out, _ = marked_split(lambda: emb.gather(ids), gather_mod, "EXCHANGE_MARK", iters)
    out.update(cap=gather_mod._bucket_cap(ids.numel(), WORLD, 2.0), rows_per_rank=ids.numel(),
               gather_call=synced_ms(lambda: emb.gather(ids)))
    return out


def world_steps(st, centers, rank, first, count, marks=None, step=None):
    """``count`` world-4 steps on this rank's share of ``centers[first:]``
    (``step`` is ``wt.train_step`` unless given); with ``marks`` (a dict),
    each step inside a ``utils.perf.Timeline`` and the device ms of the step
    and of each stage (:func:`stage_sums`) appended to ``marks[name]``."""
    dev = st.labels.device
    losses = []
    for i in range(first, first + count):
        c = centers[i][rank].to(dev)
        tl = perf.Timeline(capacity=1024, device=dev) if marks is not None else None
        with tl or contextlib.nullcontext():
            losses.append(float((step or wt.train_step)(st, c, st.labels[c.long()], seed=i)))
        if tl is not None:
            for stage, ms in stage_sums(tl).items():
                marks.setdefault(stage, []).append(ms)
    return losses


def step_split(marks):
    """:func:`world_steps`' ``marks``: (each step's device ms, each stage's median)."""
    return marks["step"], {k: statistics.median(v) for k, v in marks.items() if k != "step"}


def world_rank(rank, world, centers, check_ids):
    """One rank of ``[world]``: gloo on CUDA tensors, the store, the checked
    SGD and LazyAdam steps, the timed steps and the exchange's split."""
    import torch.distributed as dist
    from wholegraph_tpu_torch.parallel import get_global_mesh

    mesh = get_global_mesh()
    dev = mesh.device
    x = torch.arange(world, device=dev, dtype=torch.int64) + 10 * rank
    y = torch.empty_like(x)
    torch.cuda.synchronize()
    dist.all_to_all_single(y, x)
    out = {"gloo_cuda_a2a": bool(torch.equal(
        y.cpu(), torch.tensor([10 * v + rank for v in range(world)]))),
        "backend": dist.get_backend(), "device": str(dev)}
    cfg = wt.SageTrainConfig()
    t0 = time.perf_counter()
    st = world_state(cfg, "sgd", dev, mesh)
    out["build_s"] = time.perf_counter() - t0
    ids_all = torch.stack([st.graph.multilayer_sample(centers[0][r].to(dev), cfg.fanouts,
                                                      seed=0).unique_gids for r in range(world)])
    out["store"] = world_store(rank, mesh, ids_all, dev)
    del ids_all
    for opt, first in (("sgd", 0), ("lazy_adam", WORLD_STEPS)):
        if opt == "lazy_adam":
            del st
            torch.cuda.empty_cache()
            st = wt.build_synthetic(cfg, device=dev, seed=WORLD_SEED, mesh=mesh)
        losses = world_steps(st, centers, rank, first, WORLD_STEPS)
        mine = check_ids[opt].view(world, -1)[rank].to(dev)
        out[opt] = {"losses": losses, "rows": st.embedding.gather(mine).cpu(),
                    "dense": {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}}
    reset_launches()
    gather_mod.EXCHANGE_STATS.update(calls=0, rounds=0)
    marks = {}
    t0 = time.perf_counter()
    losses = world_steps(st, centers, rank, 2 * WORLD_STEPS, WORLD_TIMED, marks)
    total_s = time.perf_counter() - t0
    out["timed"] = {"losses": losses, "stage_ms": marks, "wall_s": total_s,
                    "launches": read_launches(), "exchange": dict(gather_mod.EXCHANGE_STATS),
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    ml = st.graph.multilayer_sample(centers[0][rank].to(dev), cfg.fanouts, seed=0)
    out["split"] = world_exchange_split(st.embedding, ml.unique_gids)
    del st, ml
    torch.cuda.empty_cache()
    out["epoch"] = world_epoch(cfg, mesh, centers, rank, world)
    return out


def world_epoch(cfg, mesh, centers, rank, world):
    """One world-4 epoch of WORLD_STEPS LazyAdam steps (``train.train_epoch``
    on the stacked global batches, this rank's columns by the example's
    ``rank_share``, seeds from the step's index) beside as many eager
    ``train_step``s on a second state from the same seed, both with
    deterministic algorithms: the losses, this rank's table, m and v shards
    and the dense parameters compared on the card, the eager steps' wall
    ms each and the epoch's, and the launches of the epoch alone."""
    import warnings

    dev = mesh.device
    first = 2 * WORLD_STEPS + WORLD_TIMED
    stacked = centers[first:first + WORLD_STEPS].reshape(WORLD_STEPS, -1).numpy()
    cs = torch.from_numpy(np.ascontiguousarray(rank_share(stacked, world, rank))).to(dev)
    with warnings.catch_warnings(record=True) as caught, deterministic(True):
        warnings.simplefilter("always")
        eager = wt.build_synthetic(cfg, device=dev, seed=WORLD_SEED, mesh=mesh)
        scanned = wt.build_synthetic(cfg, device=dev, seed=WORLD_SEED, mesh=mesh)
        ys = eager.labels[cs.long()]
        eager_ms, eager_losses = [], []
        for s in range(WORLD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager_losses.append(float(wt.train_step(eager, cs[s], ys[s], seed=first + s)))
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses = wt.train.train_epoch(scanned, cs, ys, torch.arange(first, first + WORLD_STEPS))
        losses = losses.tolist()  # the host's one read of the epoch
        epoch_s = time.perf_counter() - t0
        launches = read_launches()
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught if "deterministic" in str(w.message)})
    a, b = eager.embedding, scanned.embedding
    shards = {"table": (a.table, b.table), **{s: (a.slots[s], b.slots[s]) for s in a.slots}}
    equal = {k: bool(torch.equal(x, y)) for k, (x, y) in shards.items()}
    err = {k: max_err(x, y) for k, (x, y) in shards.items()}
    dense = {k: max_err(v, b_v) for (k, v), b_v in zip(eager.model.state_dict().items(),
                                                        scanned.model.state_dict().values())}
    equal["dense"] = all(v == 0.0 for v in dense.values())
    equal["losses"] = losses == eager_losses
    return {"losses": losses, "eager_losses": eager_losses, "equal": equal, "max_abs": err,
            "dense_abs": max(dense.values()), "nondeterministic": nondet,
            "epoch_graph": scanned.epoch_graph is not None,
            "steps": (a.step, b.step), "finite": bool(torch.isfinite(b.table).all()),
            "eager_ms": eager_ms, "epoch_ms_per_step": epoch_s * 1e3 / WORLD_STEPS,
            "launches": launches}


def nccl_world1():
    """NCCL at world 1 on card 0 through the port's bootstrap: one all_reduce
    and one all_to_all_single."""
    import torch.distributed as dist
    from wholegraph_tpu_torch import parallel

    with tempfile.TemporaryDirectory(prefix="wg_nccl_") as tmp:
        mesh = parallel.init(backend="nccl", device="cuda:0", init_method=f"file://{tmp}/rdv")
        try:
            x = torch.arange(4, device="cuda:0", dtype=torch.float32)
            dist.all_reduce(x)
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            torch.cuda.synchronize()
            res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                   "mesh": mesh.size, "all_reduce": x.tolist(), "all_to_all": y.tolist()}
        finally:
            parallel.finalize()
    require(res["all_reduce"] == [0.0, 1.0, 2.0, 3.0] == res["all_to_all"],
            f"NCCL at world 1 gave {res}")
    return res


def check_world_steps(tag, opt, ref, outs, cfg):
    """The world-4 steps of each rank (``outs``: its losses, its rows at
    ``ref["ids"]`` and its dense parameters) against the world-1 reference
    ``ref`` within WORLD_TOL: under SGD the table's change over its rate
    element by element, under LazyAdam the rows themselves. Logs and
    returns the errors; fails beyond the tolerance."""
    got_l = [o["losses"] for o in outs]
    loss_err = max(abs(a - b) / abs(b) for ls in got_l for a, b in zip(ls, ref["losses"]))
    dense_err = max(max_err(o["dense"][k], v) for o in outs for k, v in ref["dense"].items())
    rows4 = torch.cat([o["rows"] for o in outs])
    beyond = float(((rows4 - ref["rows"]).abs() > 1e-6).float().mean())
    if opt == "sgd":  # per element: want_i the world-1 summed gradient of the global mean
        lr, base = WORLD_SGD_LR, ref["base"].double()
        want, got = (ref["rows"].double() - base) / lr, (rows4.double() - base) / lr
        err, top = (got - want).abs(), float(want.abs().max())
        ulps = (WORLD_TOL["sgd_ulps"] * F32_EPS
                * torch.maximum(base.abs(), ref["rows"].double().abs()) / lr)
        tol = WORLD_TOL["grad_rel"] * want.abs() + WORLD_TOL["grad_abs"] * top + ulps
        touched = want != 0
        sens = float((want[touched].abs() / WORLD > tol[touched]).double().mean())
        ok = bool((err <= tol).all())
        stats = {"rows_abs": float(err.max()), "rows_excess": float((err - tol).max()),
                 "max_abs_want": top, "median_abs_want": float(want[touched].abs().median()),
                 "rows_tol_max": float(tol.max()), "rows_tol_median": float(tol.median()),
                 "touched_elements": int(touched.sum()), "sgd_sensitivity": sens,
                 # what the data needs: grad_abs with the stated grad_rel, and grad_rel alone
                 "needed_grad_abs": float(((err - WORLD_TOL["grad_rel"] * want.abs() - ulps)
                                           / top).max()),
                 "needed_grad_rel": float(((err - ulps)[touched] / want[touched].abs()).max())}
    else:
        row_err = max_err(rows4, ref["rows"])
        ok = row_err <= WORLD_TOL["lazy_atol"] and beyond <= WORLD_TOL["lazy_share"]
        stats = {"rows_abs": row_err, "rows_tol": WORLD_TOL["lazy_atol"],
                 "max_abs_move": max_err(ref["rows"], ref["base"])}
    errs = {"loss_rel": loss_err, "dense_abs": dense_err, **stats,
            "rows_share_beyond_1e-6": beyond,
            "losses_world4": got_l[0], "losses_world1": ref["losses"]}
    log(f"[{tag}] {opt} {len(ref['losses'])} steps at world {WORLD} vs world 1 ({WORLD} x "
        f"{cfg.batch} centres a step): {json.dumps(errs)}")
    require(loss_err <= WORLD_TOL["loss_rtol"], f"[{tag}] {opt}: losses differ by {loss_err}")
    require(dense_err <= WORLD_TOL["dense_atol"], f"[{tag}] {opt}: dense parameters differ by "
                                                  f"{dense_err}")
    require(ok, f"[{tag}] {opt}: table rows differ beyond the tolerance: {json.dumps(stats)}")
    require(stats.get("sgd_sensitivity", 1.0) >= WORLD_TOL["sgd_sensitivity"],
            f"[{tag}] {opt}: the check would miss a scale slip of 1/{WORLD} on most elements")
    require(all(ls == got_l[0] for ls in got_l), f"[{tag}] {opt}: the ranks' losses differ")
    return errs


def world_phase(cfg, smi):
    """``[world]``: four ranks on card 0 over gloo, each a process
    (``parallel.multiprocess_run``); their store and step checks, times
    and launch counts; NCCL at world 1 (the multichip dry run, all six of
    its parts, runs in ``[world_tier]``)."""
    log(f"[world] backend gloo, world {WORLD}, every rank on cuda:0: this machine has "
        f"{torch.cuda.device_count()} card(s), and NCCL refuses two ranks on one card. Times "
        f"below are gloo's over one card ({smi}), not NCCL's or NVLink's: they show nothing "
        f"of scaling over cards")
    t0 = time.perf_counter()
    centers = world_centers(cfg, 3 * WORLD_STEPS + WORLD_TIMED, WORLD_SEED)
    refs = {opt: world1_reference(cfg, centers, opt, first)
            for opt, first in (("sgd", 0), ("lazy_adam", WORLD_STEPS))}
    log(f"[world] world-1 references (4 x {cfg.batch} centres a step, {WORLD_STEPS} steps each) "
        f"in {time.perf_counter() - t0:.2f} s; touched rows: "
        f"{ {k: v['touched'] for k, v in refs.items()} }")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = wt.parallel.multiprocess_run(WORLD, world_rank,
                                       (centers, {k: v["ids"] for k, v in refs.items()}),
                                       backend="gloo", device="cuda:0", timeout=600)
    wall = time.perf_counter() - t0
    log(f"[world] {WORLD} ranks ran in {wall:.2f} s (spawn, init and builds included); "
        f"gloo all_to_all_single on CUDA tensors: {[r['gloo_cuda_a2a'] for r in res]}; "
        f"backends {[r['backend'] for r in res]} on {[r['device'] for r in res]}")
    require(all(r["gloo_cuda_a2a"] and r["backend"] == "gloo" for r in res),
            "gloo's all_to_all_single refused or garbled CUDA tensors")
    # the store
    for r, out in enumerate(res):
        bad = [k for k, v in out["store"]["checks"].items() if not v]
        require(not bad, f"[world] rank {r}: store checks not equal to world 1: {bad}")
    overflow = res[0]["store"]["overflow"]
    drops = sum(o["store"]["drops"]["equal"] for o in res)
    require(drops == overflow, f"a2a_capped dropped {drops} ids, gather_overflow says {overflow}")
    rounds = [o["store"]["full_skew_rounds"] for o in res]
    require(all(v["a2a"] > 1 and v["hierarchy"] > 2 for v in rounds),
            f"the fully skewed batch took one round: {rounds}")
    log(f"[world] store {cfg.n_nodes:,} x {cfg.dim} {cfg.dtype} ({cfg.n_nodes // WORLD:,} rows "
        f"a rank), plans equal/custom/"
        f"round_robin: every method (a2a, a2a_capped, allgather, ragged, hierarchy 2x2; dedup + "
        f"sorted serve) bit-equal to kernel J on the whole table, "
        f"{len(res[0]['store']['checks'])} checks a rank; a2a_capped dropped {drops} ids "
        f"(= gather_overflow), as zero rows; fully skewed batch (every id on rank 0) exact in "
        f"rounds {rounds} (a2a; hierarchy); scatter set and add equal to world 1")
    # the steps against world 1
    errs = {opt: check_world_steps("world", opt, refs[opt], [o[opt] for o in res], cfg)
            for opt in ("sgd", "lazy_adam")}
    # launches and times
    for r, out in enumerate(res):
        st, sl = out["timed"]["launches"], out["store"]["launches"]
        require(all(st[k] > 0 for k in WORLD_PATH_KERNELS),
                f"[world] rank {r}: a kernel of the step never ran: {st}")
        require(sl["sorted_gather"] > 0, f"[world] rank {r}: kernel I never ran in the store: "
                                         f"{sl}")
    step_ms, stage_med = step_split(res[0]["timed"]["stage_ms"])
    exch = res[0]["timed"]["exchange"]
    summary = {
        "step_median_ms": statistics.median(step_ms), "stage_medians_ms": stage_med,
        "rounds_per_step": exch["rounds"] / WORLD_TIMED,
        "exchange_calls_per_step": exch["calls"] / WORLD_TIMED,
        "exchange_split_ms": {k: res[0]["split"][k] for k in WORLD_SPLIT_PARTS},
        "split_shapes": {k: res[0]["split"][k] for k in ("cap", "rows_per_rank")},
        "launches_step": {r: dict(o["timed"]["launches"])
                          for r, o in enumerate(res)},
        "launches_store": {r: {k: v for k, v in o["store"]["launches"].items() if v}
                           for r, o in enumerate(res)},
        "peak_bytes_per_rank": [o["timed"]["peak_bytes"] for o in res],
        "build_s": [o["build_s"] for o in res], "checks": errs, "tol": WORLD_TOL,
        "card": smi}
    log(f"[world] {WORLD_TIMED} timed world-4 steps (LazyAdam), rank 0, on {smi}: step median "
        f"{summary['step_median_ms']:.3f} ms, stages {json.dumps(stage_med)}, "
        f"{summary['rounds_per_step']} exchange rounds a step")
    log(f"[world] exchange gather of one rank's {summary['split_shapes']['rows_per_rank']} "
        f"unique ids (bucket cap {summary['split_shapes']['cap']}), ms on {smi}: "
        f"{json.dumps(summary['exchange_split_ms'])}")
    log(f"[world] launches a rank over the timed steps: {json.dumps(summary['launches_step'])}; "
        f"in the store checks: {json.dumps(summary['launches_store'])}")
    summary["epoch"] = check_world_epoch([o["epoch"] for o in res], smi)
    summary["launches_epoch"] = {r: dict(o["epoch"]["launches"]) for r, o in enumerate(res)}
    summary["nccl_world1"] = nccl_world1()
    log(f"[world] NCCL at world 1: {json.dumps(summary['nccl_world1'])}")
    return summary


def check_world_epoch(outs, smi):
    """The world-4 epoch of every rank against its eager steps: bit for bit,
    or within WORLD_TOL where PyTorch named an op without a deterministic
    form; the launches of A, B, C, D and J on every rank; no graph kept.
    Logs and returns the readings."""
    for r, o in enumerate(outs):
        require(not o["epoch_graph"], f"[world] rank {r}: the world-4 epoch kept a graph")
        require(o["steps"] == (WORLD_STEPS, WORLD_STEPS) and o["finite"],
                f"[world] rank {r}: the epoch's steps or table are wrong: {o['steps']}")
        require(all(o["launches"][k] > 0 for k in WORLD_PATH_KERNELS),
                f"[world] rank {r}: a kernel of the epoch never ran: {o['launches']}")
        require(o["losses"] == outs[0]["losses"], f"[world] rank {r}: the ranks' losses differ")
        if not all(o["equal"].values()):
            require(o["nondeterministic"], f"[world] rank {r}: the epoch differs from its eager "
                                           f"steps with deterministic algorithms: {o['equal']}")
            loss_err = max(abs(x - y) / abs(y) for x, y in zip(o["losses"], o["eager_losses"]))
            require(loss_err <= WORLD_TOL["loss_rtol"]
                    and o["dense_abs"] <= WORLD_TOL["dense_atol"]
                    and max(o["max_abs"].values()) <= WORLD_TOL["lazy_atol"],
                    f"[world] rank {r}: the epoch lies beyond WORLD_TOL of its eager steps "
                    f"(ops without a deterministic form: {o['nondeterministic']}): "
                    f"{json.dumps({k: o[k] for k in ('max_abs', 'dense_abs')})}, losses "
                    f"{loss_err}")
    o = outs[0]
    summary = {
        "bit_equal": [all(x["equal"].values()) for x in outs],
        "equal": [x["equal"] for x in outs], "max_abs": [x["max_abs"] for x in outs],
        "dense_abs": [x["dense_abs"] for x in outs],
        "nondeterministic": sorted({n for x in outs for n in x["nondeterministic"]}),
        "losses": o["losses"], "eager_ms": o["eager_ms"],
        "eager_median_ms": statistics.median(o["eager_ms"]),
        "epoch_ms_per_step": o["epoch_ms_per_step"], "card": smi}
    log(f"[world] epoch: train_epoch of {WORLD_STEPS} LazyAdam steps at world {WORLD} (each rank "
        f"its columns of the stacked batches) against {WORLD_STEPS} eager train_steps from the "
        f"same seed, deterministic algorithms: bit-equal on every rank "
        f"{summary['bit_equal']} (losses, table, m, v, dense parameters; ops without a "
        f"deterministic form: {summary['nondeterministic'] or 'none'}); losses "
        f"{summary['losses']}; rank 0 wall ms a step, gloo over one card ({smi}): epoch "
        f"{summary['epoch_ms_per_step']:.3f}, eager median {summary['eager_median_ms']:.3f} "
        f"(each {[round(t, 3) for t in o['eager_ms']]}); launches a rank over the epoch "
        f"{json.dumps([{k: v for k, v in x['launches'].items() if v} for x in outs])}")
    return summary


# ---------------------------------------------------------------------------
# [sharded_fg]: the sharded full graph at world 4 on the one card
# ---------------------------------------------------------------------------

SFG_SEED = 14                  # the features, weights, edge types and model weights
SFG_PASSES = 5                 # timed halo evaluation passes a model (marked, then unmarked)
SFG_EDGE_NODES = 1 << 17       # the per-edge path's graph: FullGraphConfig()'s cut in nodes only
SFG_RGCN_NODES = 1 << 14       # the RGCN halo evaluation's graph (its [e_cap, Dout] messages)
SFG_RELATIONS = 3
SFG_MODELS = ("sage", "gcn", "gat")
SFG_REDUCES = {"sum": ("sum", False), "mean": ("mean", False), "max": ("max", False),
               "weighted_sum": ("sum", True)}
SFG_G_PER_PASS = {"sage": 2, "gcn": 2, "gat": 5}  # G launches in one 2-layer halo pass
# the logits at world 4 against world 1, within logits_rel of the largest |logit|: the
# aggregates are bit-equal, but the dense products of a rank's rows and of all rows may
# take other cuBLAS algorithms, and GAT's softmax sums (index_add_) add in another order
SFG_TOL = {"logits_rel": 1e-4}


def sfg_graph(n, dev, relations=0):
    """``clustered_csr(n, 16, 192)`` (the bench graph at ``n`` nodes) with
    edge weights ``U[0, 1) + 0.1`` and, with ``relations``, edge types, drawn
    on ``dev`` from SFG_SEED: the same bits in the parent and in every rank."""
    g = wt.clustered_csr(n, 16, 192, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SFG_SEED)
    w = torch.rand(g.edge_count, generator=gen, device=dev) + 0.1
    et = (torch.randint(0, relations, (g.edge_count,), generator=gen, device=dev,
                        dtype=torch.int32) if relations else None)
    return GraphStructure(g.row_ptr, g.col, n, max_degree=g.max_degree, edge_weight=w,
                          edge_type=et, num_relations=relations)


def sfg_features(n, dim, dev):
    gen = torch.Generator(device=dev).manual_seed(SFG_SEED + 1)
    return torch.randn((n, dim), generator=gen, device=dev)


def sfg_model(cfg, mt, dev, relations=0):
    """A 2-layer model at ``cfg``'s widths, weights from a CPU generator
    (the same on every device)."""
    m = HomoGNN(cfg.dim, cfg.hidden, cfg.num_classes, num_layers=cfg.num_layers, model_type=mt,
                num_heads=cfg.num_heads, num_relations=relations, device=dev)
    m.reset_parameters(torch.Generator().manual_seed(SFG_SEED))
    return m


def sfg_max_plain(row_ptr, col, x):
    """The max aggregate over a CSR in plain PyTorch, PLAIN_CHUNK edges at a
    time (an [E, D] message tensor is 21 GB at the bench shape), zero rows
    for rows without edges: exact in any order."""
    n, E, D = row_ptr.numel() - 1, col.numel(), x.shape[1]
    out = torch.full((n, D), float("-inf"), device=x.device)
    dst = S.csr_edge_dst(row_ptr, E)
    for i in range(0, E, S.PLAIN_CHUNK):
        j = slice(i, i + S.PLAIN_CHUNK)
        out.scatter_reduce_(0, dst[j, None].expand(-1, D), x[col[j].long()], "amax")
    return torch.where((row_ptr[1:] > row_ptr[:-1])[:, None], out, 0.0)


def sfg_references(spec):
    """The world-1 answers on the card, on the host: G (csr_spmm) over the
    whole CSR for the sum, mean and weighted sum, the plain max, and the
    models over the replicated FullGraph; the per-edge path's G and H
    (csr_sddmm) and its models at SFG_EDGE_NODES."""
    cfg, dev = spec["cfg"], torch.device("cuda")
    refs = {}
    with torch.no_grad():
        g = sfg_graph(cfg.n_nodes, dev)
        x = sfg_features(cfg.n_nodes, cfg.dim, dev)
        refs["degree"] = (g.row_ptr[1:] - g.row_ptr[:-1]).float()[:, None].cpu()
        for name, (reduce, weighted) in SFG_REDUCES.items():
            ref = (sfg_max_plain(g.row_ptr, g.col, x) if reduce == "max" else
                   S.csr_spmm(g.row_ptr, g.col, x, reduce=reduce,
                              edge_weight=g.edge_weight if weighted else None))
            refs["spmm", name] = ref.cpu()
        refs["K"] = longest_row(g.row_ptr)
        fg = g.to_full_graph()
        for mt in SFG_MODELS:
            refs["logits", mt] = sfg_model(cfg, mt, dev)(x, graph=fg).cpu()
        del g, x, fg
        gr = sfg_graph(spec["rgcn_nodes"], dev, SFG_RELATIONS)
        refs["logits", "rgcn"] = sfg_model(cfg, "rgcn", dev, SFG_RELATIONS)(
            sfg_features(spec["rgcn_nodes"], cfg.dim, dev), graph=gr.to_full_graph()).cpu()
        ge = sfg_graph(spec["edge_nodes"], dev)
        xe = sfg_features(spec["edge_nodes"], cfg.dim, dev)
        for reduce in ("sum", "mean"):
            refs["edge_spmm", reduce] = S.csr_spmm(ge.row_ptr, ge.col, xe, reduce=reduce).cpu()
        refs["edge_K"] = longest_row(ge.row_ptr)
        refs["sddmm"] = S.csr_sddmm(ge.row_ptr, ge.col, xe, xe).cpu()
        fge = ge.to_full_graph()
        for mt in ("sage", "gcn"):
            refs["edge_logits", mt] = sfg_model(cfg, mt, dev)(xe, graph=fge).cpu()
    torch.cuda.empty_cache()
    return refs


def sfg_timed(fn, passes):
    """``passes`` calls of ``fn`` split by the parts that
    ``graph.partitioned.HALO_MARK`` hears inside the call (:func:`marked_split`),
    then ``passes`` unmarked calls' median wall ms."""
    from wholegraph_tpu_torch.graph import partitioned as part_mod

    split, marked = marked_split(fn, part_mod, "HALO_MARK", passes)
    return {"pass_ms": synced_ms(fn, passes), "marked_pass_ms": statistics.median(marked),
            "split_ms": split}


def sfg_once_ms(fn):
    """One call's wall ms, the card synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sharded_fg_rank(rank, world, spec):
    """One rank of ``[sharded_fg]``: the halo layout at FullGraphConfig(),
    its spmm_halo and its SAGE, GCN and GAT evaluations, the RGCN one at
    SFG_RGCN_NODES, and the per-edge path at SFG_EDGE_NODES. Returns each
    result's shard on the host, times, checks and launch counts."""
    from wholegraph_tpu_torch.graph import (degrees, eval_full_graph_partitioned, halo_stats,
                                            partition_graph, spmm_halo)
    from wholegraph_tpu_torch.graph.partitioned import _xloc
    from wholegraph_tpu_torch.memory.sharded_table import local_rows
    from wholegraph_tpu_torch.models.sharded_eval import _shard_edges, eval_full_graph_sharded
    from wholegraph_tpu_torch.ops.spmm import sddmm_sharded, spmm_sharded
    from wholegraph_tpu_torch.parallel import get_global_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = get_global_mesh()
    dev, cfg, n = mesh.device, spec["cfg"], spec["cfg"].n_nodes
    out = {"launches": {}, "times": {}, "checks": {}}

    def table(n_rows, dim, rel=0):
        """The features' shard under the equal plan, and the graph."""
        t0 = time.perf_counter()
        g = sfg_graph(n_rows, dev, rel)
        full = sfg_features(n_rows, dim, dev)
        plan = wt.PartitionPlan.equal(n_rows, world)
        tab = wt.ShardedTable(local_rows(plan, rank, full), plan, "device", dev, mesh)
        torch.cuda.synchronize()
        return g, full, tab, time.perf_counter() - t0

    g, full, x_tab, out["build_s"] = table(n, cfg.dim)
    t0 = time.perf_counter()
    pg = partition_graph(g, mesh, device=dev)
    torch.cuda.synchronize()
    out["partition_s"] = time.perf_counter() - t0
    out["stats"] = halo_stats(pg)
    out["local"] = {"edges": pg.local_edges, "halo_rows": int((pg.halo_ids < n).sum()),
                    "xloc_rows": pg.plan.capacity + pg.h_cap + 1}
    # the halo gather (J serving, B un-permuting) against the rows themselves
    ids = pg.halo_ids.long()
    want = torch.where((ids < n)[:, None], full[ids.clamp(max=n - 1)], 0.0)
    out["checks"]["halo_gather_bit_equal"] = bool(torch.equal(x_tab.gather(pg.halo_ids), want))
    del full, want
    torch.cuda.empty_cache()
    # G on this rank's rectangular local CSR against its plain version, with its own counts
    xloc = _xloc(x_tab.data, x_tab.gather(pg.halo_ids))
    src = pg.src_slot[:pg.local_edges]
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    got = S.csr_spmm(pg.row_ptr, src, xloc, _stats=stats)
    plain = S.csr_spmm_plain(pg.row_ptr, src, xloc)
    out["g_local"] = {"max_abs_err": max_err(got, plain),
                      "tol": g_tol(plain, longest_row(pg.row_ptr)),
                      "unstaged_bit_equal": bool(torch.equal(
                          got, S.csr_spmm(pg.row_ptr, src, xloc, _stage=False))),
                      "stats": dict(zip(("tiles_staged", "bytes_staged", "tiles_device",
                                         "edges_device"), stats.tolist()))}
    del xloc, got, plain
    # the path: counts from 0, spmm_halo's reduces, the evaluations
    reset_launches()
    out["degrees"] = degrees(pg).data.cpu()
    for name, (reduce, weighted) in SFG_REDUCES.items():
        out["spmm", name] = spmm_halo(pg, x_tab, reduce, use_weights=weighted).data.cpu()
        torch.cuda.empty_cache()
    out["checks"]["sorted_serve_bit_equal"] = bool(torch.equal(
        spmm_halo(pg, x_tab, "sum", local_kernel="sorted").data.cpu(), out["spmm", "sum"]))
    out["launches"]["spmm_halo"] = read_launches()
    for mt in SFG_MODELS:
        model = sfg_model(cfg, mt, dev)
        before = read_launches()
        out["logits", mt] = eval_full_graph_partitioned(model, pg, x_tab).data.cpu()
        out["launches"]["pass", mt] = {k: v - before[k] for k, v in read_launches().items()}
        out["times"][mt] = sfg_timed(lambda: eval_full_graph_partitioned(model, pg, x_tab),
                                     spec["passes"])
        del model
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del g, pg, x_tab
    torch.cuda.empty_cache()
    # RGCN at a small size: its plain per-relation messages are [e_cap, Dout]
    gr, _, xr, _ = table(spec["rgcn_nodes"], cfg.dim, SFG_RELATIONS)
    pgr = partition_graph(gr, mesh, device=dev)
    model = sfg_model(cfg, "rgcn", dev, SFG_RELATIONS)
    out["logits", "rgcn"] = eval_full_graph_partitioned(model, pgr, xr).data.cpu()
    out["times"]["rgcn"] = sfg_timed(lambda: eval_full_graph_partitioned(model, pgr, xr),
                                     spec["passes"])
    out["rgcn_stats"] = halo_stats(pgr)
    out["launches"]["halo_path"] = read_launches()
    del gr, xr, pgr, model
    # the per-edge path at SFG_EDGE_NODES: the store's exact gather and accumulate-scatter
    ge, _, xe, _ = table(spec["edge_nodes"], cfg.dim)
    reset_launches()
    src, dst = _shard_edges(ge, mesh)
    for reduce in ("sum", "mean"):
        res = []
        out["times"]["edge_spmm", reduce] = sfg_once_ms(
            lambda: res.append(spmm_sharded(src, dst, xe, spec["edge_nodes"], reduce)))
        out["edge_spmm", reduce] = res[0].data.cpu()
    out["sddmm"] = sddmm_sharded(src, dst, xe, xe).cpu()
    for mt in ("sage", "gcn"):  # one pass each (a pass moves every edge's row twice a layer)
        model, res = sfg_model(cfg, mt, dev), []
        out["times"]["edge", mt] = sfg_once_ms(
            lambda: res.append(eval_full_graph_sharded(model, ge, xe)))
        out["edge_logits", mt] = res[0].data.cpu()
    out["launches"]["edge_path"] = read_launches()
    out["edge_stats"] = {"edges_per_rank": int((dst < spec["edge_nodes"]).sum()),
                         "message_bytes_per_rank": int(dst.numel()) * cfg.dim * 4}
    return out


def sharded_fg_phase(smi, spec=None):
    """``[sharded_fg]``: four ranks on card 0 over gloo, each a process. The
    halo layout of FullGraphConfig()'s graph and features: partition_graph
    (seconds, halo_stats), degrees, spmm_halo's sum, mean, max and weighted
    sum bit-equal to world-1 G (the max to its plain version), the sorted
    serve, G on each rank's local CSR against its plain version; the SAGE,
    GCN and GAT halo evaluations and RGCN at SFG_RGCN_NODES within SFG_TOL
    of world 1, each pass timed and split; the per-edge path at
    SFG_EDGE_NODES (spmm_sharded, sddmm_sharded, eval_full_graph_sharded)
    against world 1; G launched on every rank."""
    spec = spec or {"cfg": wt.FullGraphConfig(), "edge_nodes": SFG_EDGE_NODES,
                    "rgcn_nodes": SFG_RGCN_NODES, "passes": SFG_PASSES}
    cfg = spec["cfg"]
    t0 = time.perf_counter()
    refs = sfg_references(spec)
    log(f"[sharded_fg] world-1 references on the card (G over the whole CSR, the plain max, "
        f"the models over the replicated FullGraph) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    res = wt.parallel.multiprocess_run(WORLD, sharded_fg_rank, (spec,), backend="gloo",
                                       device="cuda:0", timeout=900)
    wall = time.perf_counter() - t0
    plan = wt.PartitionPlan.equal(cfg.n_nodes, WORLD)
    eplan = wt.PartitionPlan.equal(spec["edge_nodes"], WORLD)
    from wholegraph_tpu_torch.memory.sharded_table import local_rows

    summary = {"card": smi, "wall_s": wall, "tol": SFG_TOL, "ranks": {}}
    errs = {"logits": {}, "edge": {}}
    g_checks = []
    for r, out in enumerate(res):
        bad = [k for k, v in out["checks"].items() if not v]
        require(not bad, f"[sharded_fg] rank {r}: checks failed: {bad}")
        gl = out["g_local"]
        require(gl["max_abs_err"] <= gl["tol"] and gl["unstaged_bit_equal"],
                f"[sharded_fg] rank {r}: G on the local CSR against its plain version: {gl}")
        g_checks.append({"case": f"sharded_fg local CSR rank {r}",
                         "max_abs_err": gl["max_abs_err"], "tol": gl["tol"]})
        require(torch.equal(out["degrees"], local_rows(plan, r, refs["degree"])),
                f"[sharded_fg] rank {r}: degrees differ from the in-degrees")
        for name in SFG_REDUCES:
            require(torch.equal(out["spmm", name], local_rows(plan, r, refs["spmm", name])),
                    f"[sharded_fg] rank {r}: spmm_halo {name} is not bit-equal to world 1")
        for mt in SFG_MODELS + ("rgcn",):
            p = plan if mt != "rgcn" else wt.PartitionPlan.equal(spec["rgcn_nodes"], WORLD)
            want = local_rows(p, r, refs["logits", mt])
            err = max_err(out["logits", mt], want)
            tol = SFG_TOL["logits_rel"] * max(1.0, want.abs().max().item())
            errs["logits"].setdefault(mt, []).append(err)
            require(bool(torch.isfinite(out["logits", mt]).all()) and err <= tol,
                    f"[sharded_fg] rank {r}: {mt} halo logits differ from world 1 by {err} "
                    f"(tol {tol})")
        for reduce in ("sum", "mean"):
            want = local_rows(eplan, r, refs["edge_spmm", reduce])
            err, tol = max_err(out["edge_spmm", reduce], want), g_tol(want, refs["edge_K"])
            errs["edge"].setdefault(reduce, []).append(err)
            require(err <= tol, f"[sharded_fg] rank {r}: spmm_sharded {reduce} differs from "
                                f"world-1 G by {err} (tol {tol})")
        per = out["sddmm"].numel()
        want = refs["sddmm"][r * per:(r + 1) * per]
        err, tol = max_err(out["sddmm"][:want.numel()], want), h_tol(want, cfg.dim)
        errs["edge"].setdefault("sddmm", []).append(err)
        require(err <= tol and not out["sddmm"][want.numel():].any(),
                f"[sharded_fg] rank {r}: sddmm_sharded differs from world-1 H by {err} "
                f"(tol {tol})")
        for mt in ("sage", "gcn"):
            want = local_rows(eplan, r, refs["edge_logits", mt])
            err = max_err(out["edge_logits", mt], want)
            tol = SFG_TOL["logits_rel"] * max(1.0, want.abs().max().item())
            errs["edge"].setdefault(mt, []).append(err)
            require(err <= tol, f"[sharded_fg] rank {r}: per-edge {mt} logits differ from "
                                f"world 1 by {err} (tol {tol})")
        la = out["launches"]
        for mt in SFG_MODELS:
            require(la["pass", mt]["csr_spmm"] == SFG_G_PER_PASS[mt],
                    f"[sharded_fg] rank {r}: {mt} pass launched G {la['pass', mt]['csr_spmm']} "
                    f"times, not {SFG_G_PER_PASS[mt]}")
        hp = la["halo_path"]
        require(hp["csr_spmm"] > 0 and hp["row_gather_masked"] > 0 and hp["row_scatter"] > 0
                and hp["sorted_gather"] > 0,
                f"[sharded_fg] rank {r}: the halo path did not launch G, J, I and B: {hp}")
        ep = la["edge_path"]
        require(ep["row_gather_masked"] > 0 and ep["row_scatter"] > 0,
                f"[sharded_fg] rank {r}: the per-edge path did not launch J and B: {ep}")
        summary["ranks"][r] = {
            "build_s": out["build_s"], "partition_s": out["partition_s"], "local": out["local"],
            "g_local": gl, "peak_bytes": out["peak_bytes"],
            "launches_pass": {mt: {k: v for k, v in la["pass", mt].items() if v}
                              for mt in SFG_MODELS},
            "launches_halo_path": {k: v for k, v in hp.items() if v},
            "launches_edge_path": {k: v for k, v in ep.items() if v},
            "times": {(k if isinstance(k, str) else " ".join(k)): v
                      for k, v in out["times"].items()}}
    st = res[0]["stats"]
    summary.update(stats=st, rgcn_stats=res[0]["rgcn_stats"], edge_stats=res[0]["edge_stats"],
                   errs={k: {m: max(v) for m, v in d.items()} for k, d in errs.items()},
                   launches={r: {k: o["launches"]["halo_path"][k] + o["launches"]["edge_path"][k]
                                 for k in o["launches"]["halo_path"]}
                             for r, o in enumerate(res)},
                   g_checks=g_checks)
    r0 = summary["ranks"][0]
    log(f"[sharded_fg] {WORLD} ranks on cuda:0 over gloo ran in {wall:.2f} s (spawn, builds, "
        f"checks and the parent's loads included), on {smi}")
    log(f"[sharded_fg] partition_graph of clustered_csr({cfg.n_nodes}, 16, 192) (equal plan, "
        f"{plan.capacity} rows a rank): seconds a rank "
        f"{[round(o['partition_s'], 3) for o in res]}; halo_stats {json.dumps(st)}: one layer's "
        f"exchange moves {st['halo_rows']} rows against {st['per_edge_rows']} per edge; local "
        f"{[o['local'] for o in res]}")
    log(f"[sharded_fg] degrees bit-equal; spmm_halo sum, mean, weighted sum bit-equal to world-1 "
        f"G and max to the plain max, on every rank; the sorted serve (I) bit-equal; the halo "
        f"gather bit-equal to the rows; G on each local CSR within its tolerance of its plain "
        f"version and bit-equal unstaged: {json.dumps([o['g_local'] for o in res])}")
    log(f"[sharded_fg] halo logits against world 1 (max abs err over ranks, tol "
        f"{SFG_TOL['logits_rel']} of the largest |logit|): {json.dumps(summary['errs']['logits'])}; "
        f"per-edge path at {spec['edge_nodes']} nodes ({json.dumps(res[0]['edge_stats'])}): "
        f"{json.dumps(summary['errs']['edge'])}")
    for mt in SFG_MODELS + ("rgcn",):
        log(f"[sharded_fg] {mt} halo pass, rank 0, ms on {smi}: {json.dumps(r0['times'][mt])}; "
            f"G launches a pass {SFG_G_PER_PASS.get(mt, '-')}")
    log(f"[sharded_fg] per-edge, rank 0, ms on {smi}: "
        f"{json.dumps({k: v for k, v in r0['times'].items() if k.startswith('edge')})}")
    log(f"[sharded_fg] launches a rank, halo path: "
        f"{json.dumps({r: v['launches_halo_path'] for r, v in summary['ranks'].items()})}; "
        f"per-edge path: "
        f"{json.dumps({r: v['launches_edge_path'] for r, v in summary['ranks'].items()})}; "
        f"peak bytes a rank {[v['peak_bytes'] for v in summary['ranks'].values()]}")
    del refs, res
    return summary


# ---------------------------------------------------------------------------
# [world_tier]: the sampler over a sharded CSR, the host tier, the hot cache
# and the typed-node store at world 4 on the one card; the examples under
# the launcher; the multichip dry run
# ---------------------------------------------------------------------------

WT_SEED = 15              # build_synthetic's seed of the sharded-CSR and hot-cache states
WT_CSR_STEPS = 2          # SGD steps over the sharded CSR against the same over the replicated
WT_HOST_STEPS = 5         # timed LazyAdam host-tier steps (WORLD_STEPS SGD ones held to world 1)
WT_CACHE_STEPS = 3        # steps with the hot cache against as many without it
WT_HOT_RATIO = 0.2        # the hot set by degree (the examples' --cache-ratio default)
WT_COLD = (0.5, 0.1)      # gather_with_cache's cold_capacity_factor: its default, and 3+ waves
WT_HETERO_STEPS = 3       # hetero steps at HeteroTrainConfig() against world 1
WT_HETERO_SEED = 16
WT_HETERO_CHECK = 8192    # touched paper rows compared with world 1
# those rows after the LazyAdam steps against world 1: 8 times the 2.384e-7 that every sound
# run read (NVIDIA H100 80GB HBM3, 700 W); the control, each row left as it was before the
# steps (a lost update), must lie beyond it on at least WORLD_TOL["sgd_sensitivity"] of them
WT_HETERO_ROWS_TOL = 2e-6
# kernels every rank must launch on [world_tier]'s path: A, B, J and E, L's
# host route (the host tier), L (the device embedding's apply), C and D (the steps over a replicated graph), C's fetch (a
# whole col beside a sharded row_ptr); the weighted sample over a sharded CSR
# runs no K (its draw is plain PyTorch), and the dry run's weighted-fused K
# runs in its own processes
WT_PATH_KERNELS = ("row_gather", "row_scatter", "row_gather_masked", "host_gather",
                   "sparse_apply_host", "sample_hop_uniform", "neighbor_agg", "sample_cols",
                   "sparse_apply")
# tag, example, its options beyond --smoke, rank 0's test line; node_classification runs
# with and without --scan-epoch, and the two must print the same epoch losses and test line:
# both run with PyTorch's deterministic algorithms (WT_DETERMINISTIC), since two runs that
# sum by atomics may round apart in a printed digit
WT_NC_ARGS = ["--epochs", "2", "--cache-type", "local_device", "--train-embedding"]
WT_EXAMPLES = (("link_prediction", "link_prediction", ["--epochs", "1"],
                "[TEST] pairwise-rank acc"),
               ("hetero_node_classification", "hetero_node_classification",
                ["--epochs", "1", "--train-embedding"], "[TEST] loss"),
               ("node_classification", "node_classification", WT_NC_ARGS, "[TEST] loss"),
               ("node_classification_scan", "node_classification",
                WT_NC_ARGS + ["--scan-epoch"], "[TEST] loss"))
WT_DETERMINISTIC = ("node_classification", "node_classification_scan")
# the script each rank of those runs: the example's module as ``python -m`` runs it, with
# PyTorch's deterministic algorithms
WT_DETERMINISTIC_SCRIPT = """import runpy
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
runpy.run_module("wholegraph_tpu_torch.examples.{module}", run_name="__main__", alter_sys=True)
"""
DRYRUN_LINES = ("one train step OK", "host-tier train step OK", "halo-partitioned eval OK",
                "hetero train step OK", "weighted-fused sample OK", "hierarchical gather OK")


def wt_counted(total, fn):
    """``fn()`` with the launch counts from 0, its launches added to
    ``total``; returns ``fn``'s result."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    for k, v in read_launches().items():
        total[k] = total.get(k, 0) + v
    return out


def wt_same_ml(a, b):
    """Two multilayer samples bit-equal: ids, masks, and each hop's
    neighbours, mask and edge types."""
    return (torch.equal(a.unique_gids, b.unique_gids) and torch.equal(a.unique_mask, b.unique_mask)
            and all(torch.equal(x.nbr_idx, y.nbr_idx) and torch.equal(x.mask, y.mask)
                    and torch.equal(x.edge_type, y.edge_type) for x, y in zip(a.hops, b.hops)))


def wt_weighted_hops(rep, shd, ml, fanouts, seed):
    """Each hop of the weighted multilayer sample ``ml`` (over the replicated
    graph) sampled again over both graphs, from that hop's valid centres:
    the sharded hop held to kernel K's by the near-tie rule. The sharded
    hop takes the whole level (-1 on its padding), as many centres on every
    rank. Returns (near-tie centres, of them differing, breaking the rule)
    a hop."""
    out = []
    for l, K in enumerate(fanouts):
        valid = ml.level_masks[l]
        c = ml.level_gids[l][valid]
        a = rep.sample_one_hop(c, K, seed=seed, hop=l, weighted=True)
        b = shd.sample_one_hop(torch.where(valid, ml.level_gids[l], -1), K, seed=seed, hop=l,
                               weighted=True)
        near, inside = sampling_mod.weighted_near_ties(rep.row_ptr, rep.col, rep.edge_weight, c, K,
                                                       seed, l)
        out.append(sampling_mod.weighted_rule({f: getattr(b, f)[valid] for f in SAMPLE_FIELDS},
                                              {f: getattr(a, f) for f in SAMPLE_FIELDS},
                                              near, inside))
    return out


def wt_csr_part(rank, mesh, cfg, centers, total):
    """The sampler over SageTrainConfig()'s graph (weights, pseudo-relations)
    with row_ptr, col, weights and edge types as ShardedTables under the
    equal plan: the rank's 1,024 centres sampled (10, 15), uniform and
    weighted, against the replicated graph (kernels C and K), J's calls and
    rounds, the sample's ms both ways, J held against its plain version on
    every 4-byte-row serve of one sample, and WT_CSR_STEPS SGD steps over
    either graph (bit-equal losses, deterministic algorithms on)."""
    dev = mesh.device
    wcfg = dataclasses.replace(world_config(cfg, "sgd"), sample_method="weighted")
    t0 = time.perf_counter()
    st = wt.build_synthetic(wcfg, device=dev, seed=WT_SEED, mesh=mesh)
    g = st.graph
    et = ((S.csr_edge_dst(g.row_ptr, g.edge_count) + g.col) % 2).to(torch.int32)
    rep = GraphStructure(g.row_ptr, g.col, g.node_count, max_degree=g.max_degree,
                         edge_weight=g.edge_weight, cw_blocks=g.cw_blocks, edge_type=et,
                         num_relations=2)
    table = lambda t: wt.ShardedTable.from_array(t, device=dev, mesh=mesh)
    shd = GraphStructure(table(g.row_ptr), table(g.col), g.node_count, max_degree=g.max_degree,
                         edge_weight=table(g.edge_weight), edge_type=table(et), num_relations=2)
    # a sharded row_ptr beside the whole col (and edge types) on the card: C's fetch reads
    # the columns
    mixed = GraphStructure(shd.row_ptr, g.col, g.node_count, edge_type=et, num_relations=2)
    out = {"build_s": time.perf_counter() - t0, "col_shard": int(shd.col.data.shape[0])}
    c = centers[0][rank].to(dev)
    fan = cfg.fanouts

    def samples():
        res = {}
        for weighted in (False, True):
            gather_mod.EXCHANGE_STATS.update(calls=0, rounds=0)
            res["sharded", weighted] = shd.multilayer_sample(c, fan, seed=0, weighted=weighted)
            res["exchange", weighted] = dict(gather_mod.EXCHANGE_STATS)
        return res

    calls, fetches = [], []
    with capture(gather_mod, "gather_rows_masked", calls):
        res = wt_counted(total, samples)
    with capture(sampling_mod, "sample_cols", fetches):
        res["mixed"] = wt_counted(total, lambda: mixed.multilayer_sample(c, fan, seed=0))
    for w in (False, True):  # the references, not counted
        res["replicated", w] = rep.multilayer_sample(c, fan, seed=0, weighted=w)
    out["uniform_equal"] = wt_same_ml(res["sharded", False], res["replicated", False])
    out["mixed_equal"] = wt_same_ml(res["mixed"], res["replicated", False])
    out["weighted_equal"] = wt_same_ml(res["sharded", True], res["replicated", True])
    out["weighted_hops"] = wt_weighted_hops(rep, shd, res["replicated", True], fan, 0)
    out["exchange"] = {("weighted" if w else "uniform"): res["exchange", w] for w in (False, True)}
    out["j_calls_per_sample"] = len(calls)  # the uniform and the weighted sample's serves
    # C's fetch on the mixed sample's hops, against its plain version
    out["c_checks"] = [{"case": f"world_tier rank {rank} mixed CSR hop {i} sample_cols "
                                f"{list(pos.shape)} of {col.shape[0]} columns",
                        "max_abs_err": max_err(G.sample_cols(col, start, pos, mask),
                                               G.sample_cols_plain(col, start, pos, mask)),
                        "tol": 0.0} for i, (col, start, pos, mask) in enumerate(fetches)]
    out["c_calls_per_sample"] = len(fetches)
    out["sample_ms"] = {f"{how} {'weighted' if w else 'uniform'}": synced_ms(
        lambda gr=gr, w=w: gr.multilayer_sample(c, fan, seed=0, weighted=w), iters=3)
        for how, gr in (("sharded", shd), ("replicated", rep)) for w in (False, True)}
    # J on the serves' 4-byte rows ([rows, 1] int32 and f32 shards), against its plain version
    checks, biggest = [], max(calls, key=lambda a: a[1].numel())
    for i, (tab, slots) in enumerate(calls):
        err = max_err(G.gather_rows_masked(tab, slots), G.gather_rows_masked_plain(tab, slots))
        checks.append({"case": f"world_tier rank {rank} serve {i} [{slots.numel()}] of "
                               f"{list(tab.shape)} {str(tab.dtype)[6:]}",
                       "max_abs_err": err, "tol": 0.0})
    tab, slots = biggest
    valid = slots >= 0
    vs = slots[valid].long()
    n_valid = int(valid.sum())
    out["j_checks"] = checks
    out["j_time"] = {"case": f"[{slots.numel()}] of {list(tab.shape)} {str(tab.dtype)[6:]}",
                     "ms": cuda_ms(lambda: G.gather_rows_masked(tab, slots)),
                     "plain_ms": cuda_ms(lambda: G.gather_rows_masked_plain(tab, slots)),
                     "library_ms": cuda_ms(lambda: tab.index_select(0, vs)),
                     "valid": n_valid,
                     **dict(zip(("bound_ms", "bound_by"),
                                bound_ms(slots.numel() * (slots.element_size() + 4)
                                         + n_valid * 4)))}
    del calls, fetches, res
    # SGD steps over the sharded graph (counted) and over the replicated one, from one state
    st.config = dataclasses.replace(wcfg, sample_method="unweighted")
    twin = copy_state(st)
    twin.graph, st.graph = shd, rep
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        losses = {"sharded": wt_counted(total, lambda: world_steps(twin, centers, rank, 0,
                                                                   WT_CSR_STEPS)),
                  "replicated": world_steps(st, centers, rank, 0, WT_CSR_STEPS)}
    finally:
        torch.use_deterministic_algorithms(False)
    out["steps"] = losses
    del st, twin, rep, shd, mixed, g
    torch.cuda.empty_cache()
    return out


def wt_host_part(rank, mesh, cfg, centers, ids, total):
    """The host tier at SageTrainConfig() with host_cache_ratio 0.25: each
    rank's pinned shard and hot lines. WORLD_STEPS steps with the table and
    the dense parameters under SGD (:func:`world_state`), the rows at
    ``ids`` after the last; then LazyAdam: one captured step (its apply
    call, kernel L's host route, held bit for bit against the composed
    route at once; E and A against their plain versions after the count),
    WT_HOST_STEPS timed steps split by stage, coherence on the rank, pinned
    bytes, and E's and L's host route's calls a step and their link
    bytes."""
    dev = mesh.device
    out = {}
    mine = ids.view(WORLD, -1)[rank].to(dev)
    st = world_state(cfg, "sgd", dev, mesh, HOST_CACHE_RATIO)
    losses = wt_counted(total, lambda: world_steps(st, centers, rank, 0, WORLD_STEPS))
    out["sgd"] = {"losses": losses, "rows": st.embedding.gather(mine).cpu(),
                  "dense": {k: v.detach().cpu().clone() for k, v in st.model.state_dict().items()}}
    out["hot_cap"], out["capacity"] = st.embedding.hot_cap, st.embedding.plan.capacity
    out["sgd_coherent"] = coherent(st.embedding)
    del st
    free_pinned()

    st = wt.build_synthetic(cfg, device=dev, seed=WORLD_SEED, host_cache_ratio=HOST_CACHE_RATIO,
                            mesh=mesh)
    emb = st.embedding
    asked, held = pinned_bytes([emb.host_table, *emb.host_slots.values()])
    out["pinned_asked"], out["pinned_held"] = asked, held  # the held count is the process's
    calls = {k: [] for k in "AEL"}
    marks = {}

    def run():
        with capture(host_mod, "gather_rows", calls["A"]), \
                capture_kw(host_mod, "host_gather_rows", calls["E"]), \
                capture_host_apply(calls["L"]):
            first = world_steps(st, centers, rank, WORLD_STEPS, 1)
        # L's host route against the composed route, before the next steps write the tables
        l_checks = []
        for c in calls["L"]:
            l_checks += host_apply_bits(c, f"world_tier rank {rank} step apply")[0]
        timed = world_steps(st, centers, rank, WORLD_STEPS + 1, WT_HOST_STEPS, marks)
        return first + timed, l_checks

    torch.cuda.reset_peak_memory_stats()
    losses, l_checks = wt_counted(total, run)
    out["lazy_losses"], out["stage_ms"] = losses, marks
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["coherent"] = coherent(emb)
    rb = emb.dim * emb.host_table.element_size()
    out["e_calls"], out["l_calls"] = len(calls["E"]), len(calls["L"])
    out["e_link_bytes"] = sum(int(torch.unique(s[(s >= 0) & (s < t.shape[0])]).numel()) * rb
                              for (t, s), _ in calls["E"])
    out["apply_link_bytes"] = sum(host_apply_bounds(c)["link_read_bytes"] for c in calls["L"])
    checks = {"L_host": l_checks, "E": [], "A": []}
    for i, ((table, slots), kw) in enumerate(calls["E"]):
        err = max_err(H.host_gather_rows(table, slots, **kw), H.host_gather_rows_plain(table, slots))
        checks["E"].append({"case": f"world_tier rank {rank} step call{i} [{slots.numel()}] of "
                                    f"{list(table.shape)}", "max_abs_err": err, "tol": 0.0})
    errs, _ = check_gather(calls["A"])
    checks["A"] = [dict(e, case=f"world_tier rank {rank} host tier {e['case']}") for e in errs]
    out["checks"] = checks
    del calls, st, emb
    free_pinned()
    return out


def wt_cache_part(rank, mesh, cfg, centers, total):
    """The hot cache over the ranks: the top-degree WT_HOT_RATIO of
    SageTrainConfig()'s table replicated on every rank; gather_with_cache
    of the rank's unique ids bit-equal to the store's gather at each
    WT_COLD factor (waves and rounds counted); WT_CACHE_STEPS cached steps
    against as many uncached ones (deterministic algorithms on)."""
    from wholegraph_tpu_torch.embedding import (build_hot_cache, cache_hit_fraction,
                                                gather_with_cache)
    from wholegraph_tpu_torch.embedding.cache import CACHE_STATS

    dev = mesh.device
    st = wt.build_synthetic(cfg, device=dev, seed=WT_SEED, mesh=mesh)
    tab = st.embedding.as_sharded_table()
    hot = hot_ids_by_degree(st.graph.row_ptr, WT_HOT_RATIO)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = wt_counted(total, lambda: build_hot_cache(tab, hot))
    out["build_ms"] = (time.perf_counter() - t0) * 1e3
    out["lines"], out["values_bytes"] = cache.size, cache.values.nbytes
    ml = st.graph.multilayer_sample(centers[0][rank].to(dev), cfg.fanouts, seed=0)
    ids = ml.unique_gids
    out["ids"], out["hit_fraction"] = int(ml.unique_mask.sum()), cache_hit_fraction(
        cache, ids[ml.unique_mask])
    want = tab.gather(ids)
    for cf in WT_COLD:
        CACHE_STATS["waves"] = 0
        gather_mod.EXCHANGE_STATS.update(calls=0, rounds=0)
        got = wt_counted(total, lambda: gather_with_cache(tab, cache, ids,
                                                          cold_capacity_factor=cf))
        out["cold", cf] = {"equal": bit_equal(got, want), "waves": CACHE_STATS["waves"],
                           "rounds": gather_mod.EXCHANGE_STATS["rounds"],
                           "ms": synced_ms(lambda: gather_with_cache(tab, cache, ids,
                                                                     cold_capacity_factor=cf),
                                           iters=3)}
    out["store_gather_ms"] = synced_ms(lambda: tab.gather(ids), iters=3)
    twin = copy_state(st)
    st.cache = cache
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        lc = wt_counted(total, lambda: world_steps(st, centers, rank, 0, WT_CACHE_STEPS))
        lu = world_steps(twin, centers, rank, 0, WT_CACHE_STEPS)  # the reference, not counted
    finally:
        torch.use_deterministic_algorithms(False)
    out["cached_losses"], out["uncached_losses"] = lc, lu
    out["stale_lines"] = int((~st.cache.valid).sum())
    del st, twin, cache, tab
    torch.cuda.empty_cache()
    return out


def wt_hetero_part(rank, mesh, hcenters, check_ids, total):
    """HeteroTrainConfig() over the ranks, the dense parameters under SGD:
    WT_HETERO_STEPS steps on the rank's share, timed and split by stage; the rounds of each type's
    exchange with off-type slots sent as -1 (the port) and as 0 (JAX's
    ids); peak memory; the paper rows at ``check_ids`` and the dense
    parameters for the comparison with world 1."""
    dev = mesh.device
    hcfg = wt.HeteroTrainConfig()
    t0 = time.perf_counter()
    hs = wt.build_hetero(hcfg, device=dev, seed=WT_HETERO_SEED, mesh=mesh)
    # the dense parameters under SGD, as in the world-1 reference: Adam's first steps move a
    # parameter with a near-zero gradient by about its rate whatever that gradient's size, so
    # after Adam an elementwise comparison holds signs, not the ranks' averaged gradients
    hs.dense_opt = torch.optim.SGD(hs.model.parameters(), lr=hcfg.lr)
    out = {"build_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    marks = {}
    out["losses"] = wt_counted(total, lambda: world_steps(hs, hcenters, rank, 0, WT_HETERO_STEPS,
                                                          marks, step=wt.hetero_train_step))
    out["stage_ms"] = marks
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    c = hcenters[0][rank].to(dev)
    ml = hs.graph.multilayer_sample(c, hcfg.fanouts, seed=0)
    loc, masks = hs.store._type_masks(ml.unique_gids)
    rounds = {}
    for fill in (-1, 0):
        for n, m in masks.items():
            gather_mod.EXCHANGE_STATS["rounds"] = 0
            hs.store.embeddings[n].gather(torch.where(m, loc, fill).to(torch.int32))
            rounds[f"{n} {'-1' if fill < 0 else '0'}"] = gather_mod.EXCHANGE_STATS["rounds"]
    out["rounds"] = rounds
    out["slots"] = int(ml.unique_gids.numel())
    out["type_slots"] = {n: int(m.sum()) for n, m in masks.items()}
    mine = check_ids.view(WORLD, -1)[rank].to(dev)
    out["rows"] = hs.store.embeddings["paper"].gather(mine).cpu()
    out["dense"] = {k: v.detach().cpu().clone() for k, v in hs.model.state_dict().items()}
    del hs
    torch.cuda.empty_cache()
    return out


def world_tier_rank(rank, world, spec):
    """One rank of ``[world_tier]``: its four parts, each part's main path
    counted, and the launches over all of them."""
    from wholegraph_tpu_torch.parallel import get_global_mesh

    mesh = get_global_mesh()
    cfg = wt.SageTrainConfig()
    total, out, secs = {}, {}, {}
    for name, fn in (("csr", lambda: wt_csr_part(rank, mesh, cfg, spec["centers"], total)),
                     ("host", lambda: wt_host_part(rank, mesh, cfg, spec["centers"],
                                                   spec["host_ids"], total)),
                     ("cache", lambda: wt_cache_part(rank, mesh, cfg, spec["centers"], total)),
                     ("hetero", lambda: wt_hetero_part(rank, mesh, spec["hcenters"],
                                                       spec["hetero_ids"], total))):
        t0 = time.perf_counter()
        out[name] = fn()
        secs[name] = time.perf_counter() - t0
    out["launches"], out["part_s"] = total, secs
    return out


def hetero_world1():
    """The world-1 hetero steps on the card at HeteroTrainConfig() (the
    dense parameters under SGD), each on WORLD x batch distinct training
    papers: the centres (``[steps, WORLD,
    batch]``), losses, dense parameters, and the paper rows at
    WT_HETERO_CHECK of the touched ids, before and after the steps."""
    dev = torch.device("cuda")
    hs = wt.build_hetero(wt.HeteroTrainConfig(), device=dev, seed=WT_HETERO_SEED)
    paper = hs.store.embeddings["paper"]
    base = paper.table.clone()
    hs.dense_opt = torch.optim.SGD(hs.model.parameters(), lr=hs.config.lr)  # see wt_hetero_part
    train, B = hs.train_ids.cpu(), hs.config.batch
    g = torch.Generator().manual_seed(17)
    hcenters = torch.stack([train[torch.randperm(train.numel(), generator=g)[:WORLD * B]]
                            .view(WORLD, -1) for _ in range(WT_HETERO_STEPS)])
    losses = []
    for i in range(WT_HETERO_STEPS):
        c = hcenters[i].reshape(-1).to(dev)
        losses.append(float(wt.hetero_train_step(hs, c, hs.labels[c.long()], seed=i)))
    touched = torch.nonzero(paper.slots["m"].abs().sum(1) > 0)[:, 0]
    gd = torch.Generator(device=dev).manual_seed(4)
    ids = touched[torch.randperm(touched.numel(), generator=gd, device=dev)[:WT_HETERO_CHECK]]
    ids = ids.sort().values
    out = {"centers": hcenters, "losses": losses, "ids": ids.int().cpu(),
           "rows": paper.table[ids].cpu(), "base": base[ids].cpu(),
           "dense": {k: v.detach().cpu().clone() for k, v in hs.model.state_dict().items()}}
    del hs, base
    torch.cuda.empty_cache()
    return out


def wt_examples():
    """The three examples under the launcher at world 4, node_classification
    also with ``--scan-epoch``, every rank on card 0 over gloo (``--device
    cuda:0 --backend gloo``), the four launches at once (16 processes on
    the card): exit 0, rank 0's contract lines, and the scanned run's epoch
    losses and test line those of the run without the flag, both run with
    deterministic algorithms (WT_DETERMINISTIC)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    procs = {}
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="wg_launch_")
    try:
        for tag, module, extra, _ in WT_EXAMPLES:
            target = ["-m", f"wholegraph_tpu_torch.examples.{module}"]
            run_env = env
            if tag in WT_DETERMINISTIC:
                target = [os.path.join(tmp.name, f"{module}_deterministic.py")]
                with open(target[0], "w") as f:
                    f.write(WT_DETERMINISTIC_SCRIPT.format(module=module))
                run_env = dict(env, CUBLAS_WORKSPACE_CONFIG=":4096:8")
            cmd = [sys.executable, "-m", "wholegraph_tpu_torch.launch", "--nproc", str(WORLD),
                   "--device", "cuda:0", "--backend", "gloo", *target, "--", "--smoke", *extra]
            procs[tag] = (cmd, subprocess.Popen(cmd, env=run_env, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True))
        outs = {m: p.communicate(timeout=600) + (p.returncode,) for m, (_, p) in procs.items()}
    finally:
        for _, p in procs.values():  # however this ends, no launch outlives it
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    secs = time.perf_counter() - t0
    out = {}
    for tag, _, _, line in WT_EXAMPLES:
        text, err, rc = outs[tag]
        require(rc == 0, f"[world_tier] {tag} under the launcher failed ({rc}):\n"
                         f"{text[-3000:]}\n{err[-3000:]}")
        test = re.search(re.escape(line) + r".*", text)
        require(test is not None and text.count(line) == 1 and "[TRAIN_TIME]" in text,
                f"[world_tier] {tag}: rank 0's contract lines missing:\n{text}")
        cmd = procs[tag][0]
        out[tag] = {"argv": cmd[cmd.index("--") + 1:], "test": test.group(0),
                    "epochs": re.findall(r"\[EPOCH_TIME\] [0-9.]+ s (epoch .*)", text)}
        log(f"[world_tier] {tag} under the launcher at world {WORLD} on cuda:0 (gloo): "
            f"{test.group(0)}")
    eager, scan = out["node_classification"], out["node_classification_scan"]
    require(eager["epochs"] and (eager["epochs"], eager["test"]) == (scan["epochs"], scan["test"]),
            f"[world_tier] node_classification --scan-epoch at world {WORLD} printed "
            f"{scan['epochs']} {scan['test']!r}, without the flag {eager['epochs']} "
            f"{eager['test']!r}")
    log(f"[world_tier] node_classification --scan-epoch at world {WORLD}: the epoch losses and "
        f"test line of the run without it: {json.dumps(scan['epochs'])}")
    log(f"[world_tier] the four launches, side by side, in {secs:.2f} s")
    out["seconds"] = secs
    return out


def world_tier_phase(cfg, smi):
    """``[world_tier]``: four ranks on card 0 over gloo, after the parent's
    world-1 references on the card (the host tier under SGD, the hetero
    steps): the sampler over a sharded CSR, the host tier, the hot cache
    and the typed-node store at world 4 (:func:`world_tier_rank`); then the
    examples under the launcher and the multichip dry run."""
    log(f"[world_tier] backend gloo, world {WORLD}, every rank on cuda:0 ({smi}): times below "
        f"are gloo's through the host over one card and show nothing of scaling")
    t0 = time.perf_counter()
    centers = world_centers(cfg, WORLD_STEPS + 1 + WT_HOST_STEPS, WORLD_SEED + 100)
    host_ref = world1_reference(cfg, centers, "sgd", 0, host_cache_ratio=HOST_CACHE_RATIO)
    t_host = time.perf_counter() - t0
    hcfg = wt.HeteroTrainConfig()
    hetero_ref = hetero_world1()
    hcenters = hetero_ref["centers"]
    log(f"[world_tier] world-1 references on the card: the host tier, table and dense "
        f"parameters under SGD "
        f"({WORLD_STEPS} steps of {WORLD} x {cfg.batch} centres, {t_host:.2f} s), the hetero "
        f"steps ({WT_HETERO_STEPS} of {WORLD} x {hcfg.batch}) in "
        f"{time.perf_counter() - t0 - t_host:.2f} s")
    free_pinned()
    spec = {"centers": centers, "host_ids": host_ref["ids"], "hcenters": hcenters,
            "hetero_ids": hetero_ref["ids"]}
    t0 = time.perf_counter()
    res = wt.parallel.multiprocess_run(WORLD, world_tier_rank, (spec,), backend="gloo",
                                       device="cuda:0", timeout=900)
    wall = time.perf_counter() - t0
    summary = {"wall_s": wall, "card": smi, "part_s": [o["part_s"] for o in res],
               "launches": {r: o["launches"] for r, o in enumerate(res)}}
    log(f"[world_tier] {WORLD} ranks ran in {wall:.2f} s (spawn, builds and checks included); "
        f"seconds a part a rank {json.dumps(summary['part_s'])}")
    for r, o in enumerate(res):
        missing = [k for k in WT_PATH_KERNELS if not o["launches"].get(k)]
        require(not missing, f"[world_tier] rank {r} never launched {missing}: {o['launches']}")

    # the sharded CSR
    for r, o in enumerate(res):
        c = o["csr"]
        require(c["uniform_equal"], f"[world_tier] rank {r}: the uniform sample over the sharded "
                                    "CSR differs from C's over the replicated one")
        bad = [h[2] for h in c["weighted_hops"]]
        require(not any(bad), f"[world_tier] rank {r}: weighted hops break the near-tie rule: "
                              f"{c['weighted_hops']}")
        require(c["weighted_equal"] or any(h[1] for h in c["weighted_hops"]),
                f"[world_tier] rank {r}: the weighted samples differ without a near tie")
        require(all(e["max_abs_err"] == 0.0 for e in c["j_checks"]),
                f"[world_tier] rank {r}: J differs from its plain version on 4-byte rows")
        require(c["mixed_equal"] and c["c_calls_per_sample"] == len(cfg.fanouts)
                and all(e["max_abs_err"] == 0.0 for e in c["c_checks"]),
                f"[world_tier] rank {r}: the sample over a sharded row_ptr and a whole col "
                f"({c['c_calls_per_sample']} fetches) differs: {c['c_checks']}")
        require(c["steps"]["sharded"] == c["steps"]["replicated"],
                f"[world_tier] rank {r}: steps over the sharded CSR {c['steps']}")
    c0 = res[0]["csr"]
    summary["csr"] = {k: c0[k] for k in ("sample_ms", "exchange", "j_calls_per_sample",
                                         "c_calls_per_sample", "weighted_hops", "weighted_equal",
                                         "j_time", "col_shard", "build_s")}
    summary["csr"]["steps"] = c0["steps"]
    log(f"[world_tier] sharded CSR of SageTrainConfig()'s graph (a col shard of "
        f"{c0['col_shard']:,} int32 a rank): (10, 15) samples of each rank's {cfg.batch} centres "
        f"bit-equal to C's over the replicated graph (uniform), weighted hops by the near-tie "
        f"rule (near, differing, breaking) {c0['weighted_hops']}, whole weighted sample equal "
        f"{c0['weighted_equal']}; a sharded row_ptr beside the whole col bit-equal too, C's fetch "
        f"(sample_cols) {c0['c_calls_per_sample']} calls bit-equal to its plain version; "
        f"{WT_CSR_STEPS} SGD steps bit-equal {c0['steps']['sharded']}")
    log(f"[world_tier] sample ms, rank 0, on {smi}: {json.dumps(c0['sample_ms'])}; J's serves "
        f"in a uniform and a weighted sample {c0['j_calls_per_sample']}; exchange a sample "
        f"{json.dumps(c0['exchange'])}; J on its largest 4-byte-row serve "
        f"{json.dumps(c0['j_time'])}")

    # the host tier: WORLD_STEPS SGD steps (table and dense parameters) against world 1
    errs = check_world_steps("world_tier", "sgd", host_ref, [o["host"]["sgd"] for o in res], cfg)
    for r, o in enumerate(res):
        h = o["host"]
        require(h["sgd_coherent"] and h["coherent"], f"[world_tier] rank {r}: a cached row of the "
                                                     "host tier differs from its host row")
        bad = [e for es in h["checks"].values() for e in es if e["max_abs_err"] != 0.0]
        require(not bad, f"[world_tier] rank {r}: host-tier kernels differ: {bad}")
        require(h["e_calls"] == 1 and h["l_calls"] == 1,
                f"[world_tier] rank {r}: E {h['e_calls']} and L's host route {h['l_calls']} "
                f"calls a step")
    h0 = res[0]["host"]
    steps, stage_med = step_split(h0["stage_ms"])
    summary["host"] = {
        "sgd": errs, "step_median_ms": statistics.median(steps), "stage_medians_ms": stage_med,
        "lazy_losses": h0["lazy_losses"], "pinned_asked_per_rank": [o["host"]["pinned_asked"]
                                                                     for o in res],
        "pinned_held_per_rank": [o["host"]["pinned_held"] for o in res],
        "peak_bytes_per_rank": [o["host"]["peak_bytes"] for o in res],
        "e_link_bytes_per_rank": [o["host"]["e_link_bytes"] for o in res],
        "apply_link_bytes_per_rank": [o["host"]["apply_link_bytes"] for o in res],
        "hot_cap": h0["hot_cap"], "capacity": h0["capacity"]}
    log(f"[world_tier] host tier, {WT_HOST_STEPS} timed LazyAdam steps, rank 0, on {smi}: step "
        f"median {summary['host']['step_median_ms']:.3f} ms, stages "
        f"{json.dumps(summary['host']['stage_medians_ms'])}; pinned bytes a rank asked "
        f"{summary['host']['pinned_asked_per_rank']} (held {summary['host']['pinned_held_per_rank']}); "
        f"E 1 and L's host route 1 call a step, link bytes of the captured step a rank E "
        f"{summary['host']['e_link_bytes_per_rank']}, the apply "
        f"{summary['host']['apply_link_bytes_per_rank']} each way; "
        f"{h0['hot_cap']} cache lines of {h0['capacity']} rows a rank; coherent on every rank")

    # the hot cache
    for r, o in enumerate(res):
        k = o["cache"]
        require(all(k["cold", cf]["equal"] for cf in WT_COLD),
                f"[world_tier] rank {r}: gather_with_cache differs from the store's gather")
        require(k["cold", WT_COLD[1]]["waves"] >= 3,
                f"[world_tier] rank {r}: {k['cold', WT_COLD[1]]['waves']} waves at "
                f"cold_capacity_factor {WT_COLD[1]}")
        require(k["cached_losses"] == k["uncached_losses"],
                f"[world_tier] rank {r}: cached losses {k['cached_losses']} != uncached "
                f"{k['uncached_losses']}")
    k0 = res[0]["cache"]
    summary["cache"] = {key if isinstance(key, str) else f"cold {key[1]}": v
                        for key, v in k0.items()}
    log(f"[world_tier] hot cache: {k0['lines']} lines by degree ({k0['values_bytes']} bytes on "
        f"every rank, built in {k0['build_ms']:.1f} ms); rank 0's {k0['ids']} unique ids, hit "
        f"fraction over the ranks {k0['hit_fraction']}; gather_with_cache bit-equal to the "
        f"store's: " + json.dumps({cf: k0['cold', cf] for cf in WT_COLD})
        + f" against the store's gather {k0['store_gather_ms']:.3f} ms; {WT_CACHE_STEPS} cached "
        f"steps bit-equal to uncached {k0['cached_losses']}")

    # the typed-node store
    outs = [{"losses": o["hetero"]["losses"], "rows": o["hetero"]["rows"],
             "dense": o["hetero"]["dense"]} for o in res]
    loss_err = max(abs(a - b) / abs(b) for o in outs for a, b in zip(o["losses"],
                                                                     hetero_ref["losses"]))
    dense_err = max(max_err(o["dense"][k], v) for o in outs for k, v in hetero_ref["dense"].items())
    rows_err = max_err(torch.cat([o["rows"] for o in outs]), hetero_ref["rows"])
    # the control: a row left unchanged reads its largest move over the steps
    moves = (hetero_ref["rows"] - hetero_ref["base"]).abs().amax(1)
    het = {"loss_rel": loss_err, "dense_abs": dense_err, "paper_rows_abs": rows_err,
           "paper_rows_tol": WT_HETERO_ROWS_TOL, "control_max": float(moves.max()),
           "control_median": float(moves.median()), "control_min": float(moves.min()),
           "rows_sensitivity": float((moves > WT_HETERO_ROWS_TOL).double().mean()),
           "losses_world4": outs[0]["losses"], "losses_world1": hetero_ref["losses"]}
    require(loss_err <= WORLD_TOL["loss_rtol"] and dense_err <= WORLD_TOL["dense_atol"]
            and rows_err <= WT_HETERO_ROWS_TOL
            and het["rows_sensitivity"] >= WORLD_TOL["sgd_sensitivity"],
            f"[world_tier] hetero at world 4 against world 1: {het}")
    e0 = res[0]["hetero"]
    steps, stage_med = step_split(e0["stage_ms"])
    het.update(step_ms=steps, stage_medians_ms=stage_med,
               rounds={r: o["hetero"]["rounds"] for r, o in enumerate(res)},
               type_slots=e0["type_slots"], slots=e0["slots"], build_s=e0["build_s"],
               peak_bytes_per_rank=[o["hetero"]["peak_bytes"] for o in res])
    summary["hetero"] = het
    log(f"[world_tier] hetero HeteroTrainConfig() at world {WORLD} vs world 1: "
        f"{json.dumps(het)}")
    log(f"[world_tier] hetero, rank 0, on {smi}: step ms {steps}, stages "
        f"{json.dumps(het['stage_medians_ms'])}; rounds a type, off-type slots as -1 and as 0, "
        f"a rank {json.dumps(het['rounds'])} ({e0['slots']} slots, of them a type's "
        f"{e0['type_slots']}); peak bytes a rank {het['peak_bytes_per_rank']}; build "
        f"{e0['build_s']:.2f} s")

    # the examples under the launcher, then the dry run
    summary["examples"] = wt_examples()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary["dryrun_loss"] = wt.entry.dryrun_multichip(WORLD, backend="gloo", device="cuda:0")
    summary["dryrun_s"] = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[world_tier] {line}")
    missing = [ln for ln in DRYRUN_LINES if f"dryrun_multichip({WORLD}): {ln}" not in text]
    require(not missing, f"[world_tier] the dry run did not print {missing}:\n{text}")
    log(f"[world_tier] dryrun_multichip({WORLD}, gloo, cuda:0): all six parts in "
        f"{summary['dryrun_s']:.2f} s")
    summary["checks"] = {
        "J": [e for o in res for e in o["csr"]["j_checks"]],
        "C": [e for o in res for e in o["csr"]["c_checks"]],
        **{k: [e for o in res for e in o["host"]["checks"][k]] for k in ("A", "E", "L_host")}}
    return summary


def bench_entry(kern, name, launches, errs, main_call, calls, **extra):
    """One kernel's line from the times of its bench-shape call."""
    return {
        "name": name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{kern.source}",
        "replaces": kern.replaces, "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "tol": max(e["tol"] for e in errs),
        **{k: main_call[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "case": main_call["case"], "calls": calls, "checks": errs, **extra,
    }


def kernel_entry(kern, launches, errs, times, **extra):
    """One kernel's line: times per step (the sum over the step's calls; a
    library time only where every call has one); for E and F also the link
    bytes' time at the measured ``copy_`` rate, for C its parent's route and
    the fetch's ``take``."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "copy_ms", "parent_route_ms", "take_ms",
            "device_ms", "library_device_ms")
    total = {k: sum(t[k] for t in times) for k in keys if all(t.get(k) is not None for t in times)}
    total.setdefault("library_ms", None)
    return {
        "name": kern.name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{kern.source}",
        "replaces": kern.replaces, "launches": launches[kern.name],
        "max_abs_err": max(e["max_abs_err"] for e in errs),
        "tol": max(e["tol"] for e in errs), **total,
        "bound_by": "operations" if any(t["bound_by"] == "operations" for t in times) else "bytes",
        "calls": times, "checks": errs, **extra,
    }


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = kernels.build_all()
    secs[wt.io.native.SOURCE] = kernels.build_host(wt.io.native.SOURCE)  # host C++, by c++
    log(f"[build] {len(secs)} sources in {time.perf_counter() - t0:.2f} s: {secs}")
    stamp_phase()

    link = link_rates()
    log(f"[link] pinned->card {link['h2d_GBps']} GB/s, card->pinned {link['d2h_GBps']} GB/s "
        f"(1 GiB copy_, CUDA events); both at once on two streams {link['duplex_GBps']} GB/s "
        f"(2 GiB in {link['duplex_ms']} ms), against {2 * LINK_BYTES_PER_S / 1e9} GB/s at the "
        f"link's peak; on {smi}")

    cfg = wt.SageTrainConfig()
    t0 = time.perf_counter()
    state = wt.build_synthetic(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    log(f"[setup] {cfg} built in {time.perf_counter() - t0:.2f} s, "
        f"{state.graph.edge_count} edges")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def batch_of(st):
        def batch():
            c = torch.randint(0, cfg.n_nodes, (cfg.batch,), generator=gen, device=dev,
                              dtype=torch.int32)
            return c, st.labels[c.long()]
        return batch

    batch = batch_of(state)

    # one full-width step that records every kernel wrapper's arguments
    calls = {k: [] for k in ("A", "C", "D", "L")}
    with capture(emb_mod, "gather_rows", calls["A"]), \
            capture(sampling_mod, "sample_hop_uniform", calls["C"]), \
            capture(S, "neighbor_reduce", calls["D"]), capture_apply(calls["L"]):
        c, y = batch()
        loss0 = float(wt.train_step(state, c, y, seed=0))
    require(np.isfinite(loss0), f"first step loss {loss0}")
    per_step = {k: len(v) for k, v in calls.items()}
    log(f"[capture] calls per step: {per_step}, loss {loss0:.5f}")
    # A: the embedding gather; C: one fetch per hop; D: one aggregation per
    # layer; L: the apply (the table's, m's and v's rows read, updated, written)
    require(per_step == {"A": 1, "C": 2, "D": 2, "L": 1}, f"unexpected calls per step {per_step}")

    checks = {}
    for key, kern, fn in (("A", G.ROW_GATHER, check_gather),
                          ("C", sampling_mod.SAMPLE_HOP, lambda c: check_sample_hop(c, gen)),
                          ("D", S.NEIGHBOR_AGG, check_neighbor_agg)):
        require(calls[key], f"kernel {kern.name} was not called by the main path")
        checks[key] = (kern, fn(calls[key]))
        log(f"[check] {kern.name}: {json.dumps(checks[key][1][0])}")
        if key in "AD":
            log_device_calls("check", kern, checks[key][1][1])
    # kernel L at the apply's calls (a)-(d), (a) the main step's own: its line's time
    sa_errs, sa_times = check_sparse_apply(calls["L"][0], gen)
    checks["L"] = (OK.SPARSE_APPLY, (sa_errs, sa_times[:1]))
    del calls
    # kernel D at bench_spmm's call as well
    agg_bench = check_neighbor_agg([agg_bench_call(gen)])
    for e in agg_bench[0] + agg_bench[1]:
        e["case"] = "bench_spmm " + e["case"]
    log_device_calls("check", S.NEIGHBOR_AGG, agg_bench[1])

    small_parity()
    weighted_parity()
    model_parity()

    # the device-memory path: reset the counters, train, read them
    _, launches, c = timed_steps("train", state, batch, STEPS)
    require(all(launches[k.name] > 0 for k, _ in checks.values()),
            f"a kernel of the path never ran: {launches}")
    require(launches["sample_hop_uniform"] == 2 * STEPS and launches["sample_cols"] == 0,
            f"the sampler did not run one kernel C launch per hop: {launches}")
    require(bool(torch.isfinite(state.embedding.table[c.long()]).all()), "non-finite table rows")
    del state, batch
    torch.cuda.empty_cache()

    # file IO and checkpoints, then the hot cache, on a fresh device-memory state
    t0 = time.perf_counter()
    state = wt.build_synthetic(cfg, device=dev, seed=5)
    log(f"[io] a second SageTrainConfig() state built in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(prefix="wg_io_") as tmp:
        io_res = io_phase(state, batch_of(state), link, tmp)
    hc = hot_cache_phase(state, batch_of(state))
    del state
    torch.cuda.empty_cache()

    # the weighted sampler (kernel K) and the windowed sampled aggregation (D)
    w_errs, w_bench = weighted_phase()
    wt_errs, wt_times, wt_launches, wt_summary = weighted_train_phase(cfg, batch_of)
    sagg = sampled_agg_phase()
    # the sampled GCN, GAT and RGCN steps, and the hetero step
    sm, sm_checks = sampled_models_phase(cfg, batch_of)
    het, het_checks = hetero_phase()
    new_steps = {**sm, "hetero": het}
    new_checks = {**sm_checks, "hetero": het_checks}
    # the scanned epoch: one CUDA graph of the step, replayed once a batch
    scan = scan_epoch_phase(cfg, smi)

    bench, bench_errs = host_gather_phase(link)
    host_errs, host_times, host_launches, host_composed, host_apply = host_tier_phase(cfg, link)

    # the full-graph paths (kernels G and H)
    t0 = time.perf_counter()
    g = wt.clustered_csr(1 << 20, 16, 192)
    fg = g.to_full_graph(windowed=True)
    torch.cuda.synchronize()
    require(g.edge_count == 20_441_541, f"the bench graph has {g.edge_count} edges")
    require(fg.window is not None, "the bench graph's tile plan is infeasible")
    log(f"[fg_spmm] clustered_csr(2^20, 16, 192): {g.edge_count} edges, longest row "
        f"{longest_row(g.row_ptr)}, JAX plan window {fg.window}, edge_cap {fg.edge_cap}; built "
        f"in {time.perf_counter() - t0:.2f} s")
    (g_errs, g_times), (gt_errs, gt_times), g_fb = fg_spmm_phase(g, fg)
    h_errs, h_times = fg_sddmm_phase(g)
    del g, fg
    torch.cuda.empty_cache()
    gat_errs, gat_times, gat = fg_gat_phase()
    fg_parity()
    fgm = fg_model_phase()
    st_errs, st_times, st_sweep, st_launches, st_routes = store_phase()
    with tempfile.TemporaryDirectory(prefix="wg_examples_") as tmp:
        examples = examples_phase(tmp)
    torch.cuda.empty_cache()
    world = world_phase(cfg, smi)
    torch.cuda.empty_cache()
    sfg = sharded_fg_phase(smi)
    torch.cuda.empty_cache()
    wtier = world_tier_phase(cfg, smi)

    fg_launches = {k: sum(m["launches"][k] for m in fgm.values()) for k in launches}
    fg_routes = {r: sum(m["routes"].get(r, 0) for m in fgm.values())
                 for r in ("forward", "transposed")}
    fgm_checks = {r: [c for m in fgm.values() for c in m["checks"] if f" {r} " in c["case"]]
                  for r in ("forward", "transposed")}
    out = [kernel_entry(kern, launches, errs + host_errs.get(key, []), times, steps=STEPS,
                        launches_host_tier=host_launches[kern.name],
                        launches_fg_model=fg_launches[kern.name],
                        host_tier_calls=host_times.get(key, []))
           for key, (kern, (errs, times)) in checks.items()]
    # B left the main step with the apply (kernel L) and the host tier's with L's host route:
    # its line is the host tier's composed route's cache-line rewrite (a LazyAdam subclass), a
    # call a step, with the store's masked write
    composed_path = f"host_tier composed route ({HOST_COMPOSED_STEPS} steps, a LazyAdam subclass)"
    out.insert(1, kernel_entry(G.ROW_SCATTER, host_composed, host_errs["B"], host_times["B"],
                               steps=HOST_COMPOSED_STEPS, launches_path=composed_path,
                               launches_train=launches[G.ROW_SCATTER.name],
                               launches_host_tier=host_launches[G.ROW_SCATTER.name],
                               launches_fg_model=fg_launches[G.ROW_SCATTER.name]))
    b = next(e for e in out if e["name"] == G.ROW_SCATTER.name)  # B gains its masked route
    b.update(launches_masked=st_routes["masked"], store_scatter=st_times["B"][0])
    b["checks"] = b["checks"] + st_errs["B"]
    lk = next(e for e in out if e["name"] == OK.SPARSE_APPLY.name)  # L at calls (a)-(d)
    lk.update(apply_calls=sa_times, library="none: no single PyTorch call applies a sparse "
                                            "row update")
    c = next(e for e in out if e["name"] == sampling_mod.SAMPLE_HOP.name)  # C's fetch route
    c.update(library="none: no single PyTorch call samples; take_ms is the fetch's torch.take "
                     "with its index and mask in the call, for reference only",
             fetch_route={"name": G.SAMPLE_COLS.name, "entry": G.SAMPLE_COLS.entry,
                          "launches": launches[G.SAMPLE_COLS.name],
                          **{k: sum(t["fetch_route"][k] for t in c["calls"])
                             for k in ("ms", "plain_ms", "bound_ms")}})
    for e in out:  # A-D on the new steps: launches over NEW_STEPS steps, checks and calls
        e["launches_new_steps"] = {t: v["launches"][e["name"]] for t, v in new_steps.items()}
        e["new_steps"] = NEW_STEPS
        for t, ch in new_checks.items():
            if e["name"] in ch:
                e["checks"] = e["checks"] + ch[e["name"]][0]
                e["calls_" + t] = ch[e["name"]][1]
        e["max_abs_err"] = max(c["max_abs_err"] for c in e["checks"])
        e["tol"] = max(c["tol"] for c in e["checks"])
    a = next(e for e in out if e["name"] == G.ROW_GATHER.name)  # the new steps' readings
    a["new_step_summaries"] = {t: {k: v for k, v in s.items() if k != "launches"}
                               for t, s in new_steps.items()}
    d = next(e for e in out if e["name"] == S.NEIGHBOR_AGG.name)  # D gains the windowed call
    d.update(sampled_agg=sagg, bench_spmm=agg_bench[1][0])
    d["checks"] = (d["checks"] + [{k: sagg[k] for k in ("case", "max_abs_err", "tol")}]
                   + agg_bench[0])
    d["max_abs_err"] = max(c["max_abs_err"] for c in d["checks"])
    d["tol"] = max(c["tol"] for c in d["checks"])
    # E: the host-tier step's gather of its misses, a call a step (its three reads on the
    # composed route beside it); F: the composed route's write-backs, three a step
    out.append(kernel_entry(H.HOST_GATHER, host_launches, host_errs["E"] + bench_errs,
                            host_times["E"][:1], steps=HOST_STEPS, bench=bench, link=link,
                            composed_route_calls=host_times["E"][1:],
                            launches_composed_route=host_composed[H.HOST_GATHER.name]))
    out.append(kernel_entry(H.HOST_SCATTER, host_composed, host_errs["F"], host_times["F"],
                            steps=HOST_COMPOSED_STEPS, launches_path=composed_path,
                            launches_host_tier=host_launches[H.HOST_SCATTER.name], link=link))
    # L's host route: the host-tier step's apply, a launch a step
    lh = OK.SPARSE_APPLY_HOST
    out.append({
        "name": lh.name, "route": "cuda", "source": f"wholegraph_tpu_torch/csrc/{lh.source}",
        "replaces": lh.replaces, "launches": host_launches[lh.name],
        "max_abs_err": max(e["max_abs_err"] for e in host_errs["L_host"]),
        "tol": max(e["tol"] for e in host_errs["L_host"]),
        **{k: host_apply[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "none: no single PyTorch call applies a sparse row update",
        "case": host_apply["case"], "steps": HOST_STEPS,
        "launches_path": f"host_tier ({HOST_STEPS} steps)",
        "launches_composed_route": host_composed[lh.name], "calls": [host_apply],
        "checks": host_errs["L_host"], "link": link})
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm", fg_routes["forward"],
                        g_errs + gat_errs["forward"] + fgm_checks["forward"], g_times[0],
                        g_times + gat_times["forward"], call_route="forward",
                        launches_per_call=g_times[0]["kernels_per_call"],
                        launches_fg_gat=gat["routes"].get("forward", 0),
                        fg_model=fgm, fg_gat=gat))
    out.append(bench_entry(S.CSR_SPMM, "csr_spmm_transposed", fg_routes["transposed"],
                        gt_errs + gat_errs["transposed"] + fgm_checks["transposed"], gt_times[0],
                        gt_times + gat_times["transposed"], call_route="transposed",
                        launches_per_call=gt_times[0]["kernels_per_call"],
                        launches_fg_gat=gat["routes"].get("transposed", 0),
                        spmm_window_fwd_bwd=g_fb))
    out.append(bench_entry(S.CSR_SDDMM, "csr_sddmm", gat["launches"]["csr_sddmm"],
                        h_errs + gat_errs["sddmm"], h_times[0], h_times + gat_times["sddmm"],
                        launches_per_call=h_times[0]["kernels_per_call"],
                        launches_path="fg_gat (one forward + backward)"))
    out.append(bench_entry(G.SORTED_GATHER, "sorted_gather", st_launches["sorted_gather"],
                           st_errs["I"], st_times["I"][0], st_times["I"], sweep=st_sweep,
                           launches_path="store (f32 and bf16 sorted gathers)"))
    out.append(bench_entry(G.ROW_GATHER_MASKED, "row_gather_masked",
                           st_launches["row_gather_masked"], st_errs["J"], st_times["J"][0],
                           st_times["J"], launches_path="store (ring gather)"))
    out.append(bench_entry(
        KW, KW.name, wt_launches[KW.name], w_errs + wt_errs, w_bench, [w_bench] + wt_times,
        launches_path=f"weighted_train ({WEIGHTED_STEPS} steps)", launches_per_hop=1,
        launches_per_step=wt_launches[KW.name] / WEIGHTED_STEPS,
        step_ms={k: sum(t[k] for t in wt_times) for k in ("ms", "device_ms", "plain_ms",
                                                           "bound_ms")},
        library="none: no single PyTorch call samples; topk_ms is torch.topk of the ready "
                "padded key matrix, for reference only",
        weighted_train=wt_summary))
    for e in out:  # the eleventh slice's runs: launches of each example run
        e["launches_examples"] = {k: v["launches"].get(e["name"], 0) for k, v in examples.items()}
    a = next(e for e in out if e["name"] == G.ROW_GATHER.name)
    a.update(hot_cache=hc, io=io_res, world=world)
    for e in out:  # the twelfth slice: each rank's launches in [world]'s timed steps and store
        e["launches_world_step"] = {r: v.get(e["name"], 0)
                                    for r, v in world["launches_step"].items()}
        e["launches_world_store"] = {r: v.get(e["name"], 0)
                                     for r, v in world["launches_store"].items()}
        # the sixteenth slice: each rank's launches over [world]'s epoch
        e["launches_world_epoch"] = {r: v.get(e["name"], 0)
                                     for r, v in world["launches_epoch"].items()}
        # the thirteenth slice: each rank's launches over [sharded_fg]'s halo and per-edge paths
        e["launches_sharded_fg"] = {r: v.get(e["name"], 0) for r, v in sfg["launches"].items()}
    gk = next(e for e in out if e["name"] == S.CSR_SPMM.name)  # G on each rank's local CSR
    gk["checks"] = gk["checks"] + sfg["g_checks"]
    gk["max_abs_err"] = max(c["max_abs_err"] for c in gk["checks"])
    gk["tol"] = max(c["tol"] for c in gk["checks"])
    gk["sharded_fg"] = {k: sfg[k] for k in ("stats", "rgcn_stats", "edge_stats", "errs", "ranks")}
    # the fourteenth slice: each rank's launches over [world_tier]'s paths, and the checks of
    # A, E and L's host route (the host tier's captured step), J (the sharded CSR's 4-byte rows)
    # and C's fetch (a whole col beside a sharded row_ptr) there
    keys = {G.ROW_GATHER.name: "A", H.HOST_GATHER.name: "E", OK.SPARSE_APPLY_HOST.name: "L_host",
            G.ROW_GATHER_MASKED.name: "J", sampling_mod.SAMPLE_HOP.name: "C"}
    for e in out:
        e["launches_world_tier"] = {r: v.get(e["name"], 0) for r, v in wtier["launches"].items()}
        if e["name"] in keys:
            e["checks"] = e["checks"] + wtier["checks"][keys[e["name"]]]
            e["max_abs_err"] = max(c["max_abs_err"] for c in e["checks"])
            e["tol"] = max(c["tol"] for c in e["checks"])
    ck = next(e for e in out if e["name"] == sampling_mod.SAMPLE_HOP.name)
    ck["fetch_route"]["launches_world_tier"] = {r: v.get(G.SAMPLE_COLS.name, 0)
                                                for r, v in wtier["launches"].items()}
    j = next(e for e in out if e["name"] == G.ROW_GATHER_MASKED.name)
    j["world_tier_csr"] = wtier["csr"]["j_time"]
    a = next(e for e in out if e["name"] == G.ROW_GATHER.name)
    a["world_tier"] = {k: v for k, v in wtier.items() if k not in ("launches", "checks")}
    # the fifteenth slice: launches in [scan_epoch]'s default-mode graphed run, as the warm-up's
    # plus the captured step's times the graph's replays (the counters count a wrapper's calls
    # at capture, once; TimedGraph counts the replays), and C's and K's checks in the graph
    for e in out:
        e["launches_scan_epoch"] = {}
        for t, v in scan.items():
            n, w = v["captured_step_launches"].get(e["name"], 0), v["warmup_launches"].get(
                e["name"], 0)
            e["launches_scan_epoch"][t] = {"warmup": w, "captured_step": n,
                                           "replays": v["replays"],
                                           "total": w + n * v["replays"]}
        scan_checks = [ch for v in scan.values() for ch in v["checks"]
                       if (" hop" in ch["case"]) and (("near_ties" in ch) == (e["name"] == KW.name))
                       and e["name"] in (KW.name, sampling_mod.SAMPLE_HOP.name)]
        if scan_checks:
            e["checks"] = e["checks"] + scan_checks
    a = next(e for e in out if e["name"] == G.ROW_GATHER.name)
    a["scan_epoch"] = {t: {k: v for k, v in s.items() if k not in ("checks", "launches")}
                       for t, s in scan.items()}
    log(json.dumps({"kernels": out}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--paired-times"]:
        require(set(sys.argv[2:]) <= set(PAIRED_PARTS + OWN_PARTS),
                f"--paired-times takes parts among {PAIRED_PARTS + OWN_PARTS}, got {sys.argv[2:]}")
        paired_times(tuple(sys.argv[2:]) or PAIRED_PARTS)
    else:
        main()
