"""The benchmark of myscaledb_tpu_torch: one run of one cell a process.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by its name in BENCHMARK.json:
configs/<config>.json, traffic/<traffic>.json, cells/<cell>.json and
metrics/<metric>.py; loops/<loop>.py are the load generators a traffic file
names, references/<reference>.py the plain reference a configuration names
(or its traffic, for a text or hybrid search of the table). Nothing here
imports JAX or the JAX package.
"""
