"""The port's benchmark entry points, twins of cfjax's: `headline` (of
`bench.py`), `run_baseline` (of `benchmarks/run_baseline.py`, the BASELINE
table) and `weak_scaling` (of `benchmarks/weak_scaling.py`). Each runs on
the card unless asked for the CPU (`--device cpu`) and exits with an
error when there is no card; none writes into cfjax's files."""
