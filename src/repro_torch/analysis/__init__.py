"""Analysis of the port's runs: ``obs_report`` reads a telemetry trace.

The JAX package's HLO cost model, roofline and report (``analysis/hlo.py``,
``roofline.py``, ``report.py``) read its compiled HLO and a TPU model and
have no counterpart here yet.
"""
