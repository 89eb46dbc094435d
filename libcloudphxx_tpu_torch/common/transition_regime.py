"""Transition-regime correction (libcloudphxx_tpu/common/transition_regime.py;
reference transition_regime.hpp)."""


def beta(Kn):
    """Fuchs-Sutugin correction factor (transition_regime.hpp:13-20)."""
    return (1 + Kn) / (1 + 1.71 * Kn + 1.33 * Kn * Kn)
