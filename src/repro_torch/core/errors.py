"""Exception value model shared by the IR transforms and the runtime.

X10 semantics (paper §2.1): an exception thrown inside an ``async`` is
caught by its Immediately Enclosing Finish; the finish waits for the
remaining tasks, packages everything thrown as a ``MultipleExceptions``
(here: an :class:`ExcValue` with ``is_me=True``) and rethrows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class ExcValue:
    """A first-class exception value (storable in IR variables)."""

    type_name: str = "Exception"
    payload: Any = None
    is_me: bool = False
    inner: Tuple["ExcValue", ...] = ()

    def matches(self, catch_types: tuple) -> bool:
        if self.type_name in catch_types:
            return True
        if "Exception" in catch_types:
            return True  # Exception is the root supertype
        if self.is_me and "ME" in catch_types:
            return True
        return False

    def flatten(self) -> Tuple["ExcValue", ...]:
        """All non-ME leaf exceptions inside this value."""
        if not self.is_me:
            return (self,)
        out: tuple = ()
        for e in self.inner:
            out = out + e.flatten()
        return out


def make_me(*excs: ExcValue) -> ExcValue:
    return ExcValue(type_name="ME", is_me=True, inner=tuple(excs))


class SimException(Exception):
    """Python carrier for an :class:`ExcValue` inside the interpreter."""

    def __init__(self, value: ExcValue):
        super().__init__(value.type_name)
        self.value = value
