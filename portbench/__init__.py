"""The benchmark of fscl_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see run.py).  Everything that measures
the program lives here and imports nothing of the JAX package; the plain
reference under ``ref/`` imports nothing of the program either.
"""
