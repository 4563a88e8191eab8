"""Fault-tolerant training of the port (the counterpart of ``repro.runtime``)."""

from repro_torch.runtime.driver import (HostFailure, TrainDriver, TrainDriverConfig,
                                        make_failure_injector)

__all__ = ["HostFailure", "TrainDriver", "TrainDriverConfig", "make_failure_injector"]
