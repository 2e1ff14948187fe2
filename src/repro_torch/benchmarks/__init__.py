"""The port's benchmark entry points, run as modules
(``python -m repro_torch.benchmarks.<name>``).  The suite under the
repository's ``benchmarks/`` drives the reference package; these drive the
port on its device."""
