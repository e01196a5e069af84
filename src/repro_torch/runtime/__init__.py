"""Fault tolerance (port of ``repro.runtime``): heartbeats, stragglers,
restart, resize, chaos."""

from repro_torch.runtime import fault
from repro_torch.runtime.fault import (DecodeFault, FailureInjector,
                                       FaultPlan, HeartbeatMonitor,
                                       InjectedKernelFailure, ResizeEvent,
                                       SimulatedFailure, TrainSupervisor,
                                       TransientServeError,
                                       active_fault_plan)

__all__ = [
    "fault",
    "DecodeFault", "FailureInjector", "FaultPlan", "HeartbeatMonitor",
    "InjectedKernelFailure", "ResizeEvent", "SimulatedFailure",
    "TrainSupervisor", "TransientServeError", "active_fault_plan",
]
