"""The benchmark of `vstab_torch` on NVIDIA H100 cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix, cell or per-layer metric is
a file of its own, found by its name:

- `configs/<config>.json`: the configuration as it is run;
- `traffic/<traffic>.json`: a traffic mix, the parameters of a generator
  in `generators/`;
- `workloads/<cell>.json`: the entry a cell drives (a module of
  `drivers/`), how many of its outputs are judged, and the limits of the
  numbers compared;
- `metrics/<metric>.py`: the reader of one per-layer metric;
- `counts/`: peaks, PWC-Net's operations, each kernel launch's bytes;
- `reference/`: the plain reference that decides `correct`;
- `control.py`: the readings the limits are set from (program, control,
  faults) on the card.
"""
