"""Where a run executes: on the GPU or on the host CPU, decided once.

`Options.device` names the choice: "gpu", "cpu", or None for JAX's default
backend. Every module that has a device branch and a host branch asks
`on_device()` instead of inspecting the JAX backend itself, so a run that
asked for the host (the oracle run beside a GPU run, or a machine without a
card) takes the host path everywhere: native scan, native join, native
exact solver.

Any other JAX backend is refused with an error rather than run down an
untested path.
"""

from __future__ import annotations

import contextlib

_PLATFORMS = ("gpu", "cpu")
_current: str | None = None


def resolve(device: str | None = None) -> str:
    """'gpu' or 'cpu' for a requested device (None = JAX's default backend).

    Raises when the request cannot be honoured: 'gpu' without a GPU (the
    run fails rather than carrying on on the CPU), a default backend that
    is neither, or an unknown name."""
    import jax
    if device is None:
        device = jax.default_backend()
        if device not in _PLATFORMS:
            raise RuntimeError(
                f"JAX's default backend is {device!r}; this program runs on "
                "a GPU ('gpu') or the host ('cpu') only")
        return device
    if device not in _PLATFORMS:
        raise ValueError(
            f"device must be 'gpu', 'cpu' or None, got {device!r}")
    if device == "gpu":
        try:
            jax.devices("gpu")
        except RuntimeError as e:
            raise RuntimeError(
                "device='gpu' was requested but JAX finds no GPU") from e
    return device


def current() -> str:
    """The platform of the run in progress ('gpu' | 'cpu')."""
    return _current if _current is not None else resolve(None)


def on_device() -> bool:
    """True when the run in progress executes its device phases on a GPU."""
    return current() == "gpu"


@contextlib.contextmanager
def use(device: str | None):
    """Run the enclosed block on the resolved platform: sets `current()` and
    makes that platform's first device JAX's default, so arrays and jitted
    programs of a host-requested run stay off the card."""
    import jax
    global _current
    choice = resolve(device)
    prev = _current
    _current = choice
    try:
        with jax.default_device(jax.devices(choice)[0]):
            yield choice
    finally:
        _current = prev
