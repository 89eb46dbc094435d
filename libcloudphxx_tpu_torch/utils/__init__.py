"""utils: debug instrumentation and profiling helpers
(libcloudphxx_tpu/utils).

The reference's debug tier is the nancheck instrumentation compiled into
THRUST_DEBUG builds (src/detail/checknan.hpp, after every phase, e.g.
particles_step.ipp:114-128, coal.ipp:453-456).  Here it is switched on per
instance: factory(..., debug=True) (or Kinematic2D(..., debug=True)) makes
step_cond and step_async sweep the state for NaN and Inf and raise with
the array and the phase named; the JAX package reads LIBCLOUD_DEBUG
instead, and the port reads no environment variable.  The reference ships
no profiler (SURVEY section 5 asks for a step timer); StepTimer is that
utility.
"""

from .debug import nancheck, nancheck_state
from .timing import StepTimer

__all__ = ["StepTimer", "nancheck", "nancheck_state"]
