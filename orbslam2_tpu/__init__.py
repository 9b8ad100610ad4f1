"""orbslam2_tpu — a JAX-native visual SLAM engine.

A from-scratch re-design of the capabilities of ORB-SLAM2 (reference:
YHY138/ORB-SLAM2-, an annotated fork of Mur-Artal's ORB-SLAM2) as
JAX/XLA/Pallas device programs orchestrated by a host-side functional
pipeline: FAST+oriented-BRIEF extraction over an image pyramid, BoW place
recognition, Hamming descriptor matching, PnP/essential-matrix tracking,
batched Schur-complement bundle adjustment, and Sim(3) loop closure with
pose-graph optimization.
"""
import jax as _jax

# Geometry code (pose LM, BA, triangulation, Sim3) is accuracy-critical:
# a reduced-precision f32 matmul (TF32 on NVIDIA tensor cores keeps about
# three decimal digits) loses the sub-pixel residuals that pose LM and BA
# converge on. The engine's matmuls are tiny, so full f32 costs nothing.
_jax.config.update("jax_default_matmul_precision", "float32")

from .config import Sensor, SlamConfig, OrbParams, load_settings  # noqa: F401,E402
from .system import System  # noqa: F401,E402

__version__ = "0.1.0"
