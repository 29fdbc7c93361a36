"""Visual-inertial SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
LY-zhang-yi-hao/ORB-SLAM3_byZyh (ORB-SLAM3 V1.0 fork): visual / visual-inertial
multi-map SLAM for monocular, stereo and RGB-D sensors with pinhole and
Kannala-Brandt fisheye camera models.
"""

__version__ = "0.1.0"
