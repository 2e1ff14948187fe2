"""The port's benchmark harness, run as modules
(``python -m repro_torch.benchmarks.<name>``): the paper's Fig. 1
(``fig1_blas_efficiency``), Figs. 2 and 3-4 (``fig2_alpha_beta``,
``fig34_calibration``) and Figs. 5-8 (``fig5to8_validation``) over a
``torch.distributed`` group, Tables II-V (``tables_2to5_predictions``),
the emitters of the tuner, simulator, telemetry, observability, serving
and fault layers (``bench_*``), and ``run``, which drives them all, writes
stamped JSONs under ``artifacts/bench_torch/`` and holds the
bench-history regression sentinel (``--check-regressions``).  The suite
under the repository's ``benchmarks/`` drives the reference package;
these drive the port, on its device where a bench touches one."""
