"""Presets by name for the CLIs: ``config``'s SpeechT5 presets, and those
of the model families whose preset lives beside its model, as in the JAX
package (``speech2c_base``, JAX ``models/speech2c.py``)."""

from __future__ import annotations

from .. import config as C

#: preset name -> the family whose module holds it and builds its model
FAMILY_ARCHS = {"speech2c_base": "speech2c"}


def arch_config(name: str, **kw):
    """The preset ``name`` with ``kw`` replaced."""
    if FAMILY_ARCHS.get(name) == "speech2c":
        from .speech2c import speech2c_base

        return speech2c_base(**kw)
    return getattr(C, name)(**kw)


def init_for_arch(name: str, cfg, generator=None, device="cuda"):
    """The model of preset ``name``'s family at ``cfg`` (random weights
    from ``generator``), on ``device`` in eval mode."""
    if FAMILY_ARCHS.get(name) == "speech2c":
        from .speech2c import init_speech2c

        return init_speech2c(cfg, generator, device)
    from .speecht5 import init_model

    return init_model(cfg, generator, device)
