"""Host models (libcloudphxx_tpu/models): the kinematic 2-D model and its
MPDATA advection."""

from .kinematic_2d import Kinematic2D, Setup

__all__ = ["Kinematic2D", "Setup"]
