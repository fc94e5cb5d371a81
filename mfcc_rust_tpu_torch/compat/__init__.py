"""Drop-in shims for upstream Python libraries whose semantics the port
reproduces."""

from . import speechpy  # noqa: F401
