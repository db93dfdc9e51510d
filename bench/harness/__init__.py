"""The benchmark harness: the pieces `bench/run.py` puts together.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own under `bench/configs`, `bench/traffic`
or `bench/metrics`, found by the name `BENCHMARK.json` gives it.  A
traffic file's `kind` names the driver module `harness/driver_<kind>.py`
that runs it.
"""
