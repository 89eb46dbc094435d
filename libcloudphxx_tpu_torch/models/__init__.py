"""Host models (libcloudphxx_tpu/models): the kinematic 2-D model, its
MPDATA advection and its command line driver (cli, icicle-tpu)."""

from .kinematic_2d import Kinematic2D, Setup

__all__ = ["Kinematic2D", "Setup", "cli"]


def __getattr__(name):
    # cli is imported on first use, so that ``python -m
    # libcloudphxx_tpu_torch.models.cli`` runs it as a fresh module
    if name == "cli":
        import importlib
        return importlib.import_module(f"{__name__}.cli")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
