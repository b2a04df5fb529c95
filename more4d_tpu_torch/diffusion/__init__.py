from .flow_match import (FlowDPMScheduler, FlowEulerScheduler,
                         FlowUniPCScheduler, euler_sigmas, get_scheduler,
                         sampling_sigmas, shift_sigmas)

__all__ = ["FlowEulerScheduler", "FlowDPMScheduler", "FlowUniPCScheduler",
           "get_scheduler", "euler_sigmas", "sampling_sigmas",
           "shift_sigmas"]
