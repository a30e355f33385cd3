"""The port's scheduler package: the CPU oracle (copies of
``nomad_tpu/scheduler/``), the registry, and the harness.  The batch
scheduler itself lives in ``ops/batch_sched.py`` and registers as
``torch-batch``; :func:`new_scheduler` imports it on first use."""
