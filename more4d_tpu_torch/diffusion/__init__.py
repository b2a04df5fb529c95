from .flow_match import (FlowEulerScheduler, euler_sigmas, get_scheduler,
                         shift_sigmas)

__all__ = ["FlowEulerScheduler", "get_scheduler", "euler_sigmas",
           "shift_sigmas"]
