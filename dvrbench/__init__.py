"""The benchmark of ``differender_tpu_torch`` on one H100: volume fitting
and the inference viewer, each on a CT-like and a dense scene.

``python3 -m dvrbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell (see ``BENCHMARK.json``); ``python3 -m
dvrbench.calibrate`` takes the readings that the correctness limits were
set from.  Nothing here imports JAX or the JAX package.
"""
