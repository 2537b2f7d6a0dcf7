"""Continuous-batching serving of the PyTorch port."""

from repro_torch.serving.config import RequestResult, ServeConfig  # noqa: F401
from repro_torch.serving.engine import ServeEngine  # noqa: F401
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: F401
from repro_torch.serving.export import ExportReport, export_for_serving  # noqa: F401
