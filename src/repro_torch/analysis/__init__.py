"""Analysis of the port's runs: ``obs_report`` reads a telemetry trace;
``roofline`` (an H100 model beside the reference's v5e one, and the
hand-written kernels' costs), ``cost`` (a step's FLOPs and bytes counted
as it runs, the counterpart of the reference's HLO parser) and ``report``
(the roofline table over ``launch/dryrun.py``'s cells).
"""
