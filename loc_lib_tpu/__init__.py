"""loc_lib_tpu: a SLAM / LiDAR-localization engine in JAX.

Brand-new JAX/XLA rebuild of the capabilities of the reference C++
library `maotian123/loc_lib` (LocUtils + slam_demo). See SURVEY.md for the
blueprint and the file:line parity citations in each module's docstring.
"""

import jax as _jax

# SLAM solvers depend on f32-true linear algebra: residuals are meter-scale
# values at ~100 m range, and on the GPU a float32 matmul may otherwise run
# in TF32 (~2^-11 relative), which puts centimetre noise into every ICP/NDT
# Gauss-Newton step, the size of the 0.1 m plane gate. All matmuls in this
# library are tiny (3x3/6x6/18x18) or bandwidth-bound (Nx3 point
# transforms), so full f32 passes cost nothing.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
