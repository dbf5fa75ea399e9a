from .simulate import (DEFAULT_SCALES, build_sharded_simulation,
                       count_errors, simulate_sharded)

__all__ = ["DEFAULT_SCALES", "build_sharded_simulation", "count_errors",
           "simulate_sharded"]
