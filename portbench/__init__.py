"""portbench: the benchmark of rowbowt_tpu_torch, the PyTorch and CUDA port.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each cell of BENCHMARK.json names a configuration (configs/<name>.json: a
synthetic pangenome panel and the index built from it) and a traffic mix
(traffic/<name>.json: the query class, batch size, padded width, read
length and substitution rate).  The window is the port's query path as
rbt_align's query loop drives it, from encoded batches to result arrays on
the host, with no text formatted.  A plain numpy reference (reference.py)
decides `correct`; the per-layer metrics are readers of their own
(metrics/<name>.py) over the traced run's spans, profile and counters.
Nothing here imports jax or the JAX package.
"""
