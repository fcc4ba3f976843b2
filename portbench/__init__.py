"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the CUDA card
and prints one JSON result line.  Everything that belongs to one
configuration, traffic mix, cell, per-layer metric, kernel family or
reference model is a file of its own that the harness finds by name:

    configs/<config>.json      the deployment: graph, model, widths
    traffic/<traffic>.json     the mix: which mode drives it, and its knobs
    workloads/<cell>.json      the cell's limits and traced iterations
    modes/<mode>.py            the driver of one kind of traffic
    metrics/<metric>.py        a reader of one per-layer metric
    kernels/<family>.json      name patterns of one kernel family
    reference/<model>.py       the plain PyTorch model the check runs,
                               and, where it defines `model_flops` and
                               `aggregate_bytes`, the model's least work

`lib/` holds the yardstick the cells share: the R-MAT rule, the DASR
counts of least work for a model whose reference defines none (GCN's,
R-GCN's), the profiler summing, the peaks, the comparisons.  A model's
own count stays a least count: never above the work the model needs.
Nothing here imports JAX, the JAX package `repro` or `benchmarks/`.
"""
