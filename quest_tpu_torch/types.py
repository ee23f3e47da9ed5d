"""Public enums and exception types.

Mirrors the reference's public type surface (``QuEST.h:97`` pauliOpType and the
fatal-error channel ``QuEST_validation.c:126-137``) in Python-native form: the
overridable weak symbol ``invalidQuESTInputError`` becomes an exception class
plus a swappable module-level handler hook.
"""

from __future__ import annotations

import enum

__all__ = [
    "PauliOpType",
    "PAULI_I",
    "PAULI_X",
    "PAULI_Y",
    "PAULI_Z",
    "QuESTError",
    "invalid_quest_input_error",
    "invalidQuESTInputError",
    "set_input_error_handler",
]


class PauliOpType(enum.IntEnum):
    """Pauli operator codes (value-compatible with the reference enum)."""

    PAULI_I = 0
    PAULI_X = 1
    PAULI_Y = 2
    PAULI_Z = 3


PAULI_I = PauliOpType.PAULI_I
PAULI_X = PauliOpType.PAULI_X
PAULI_Y = PauliOpType.PAULI_Y
PAULI_Z = PauliOpType.PAULI_Z


class QuESTError(ValueError):
    """Raised on invalid user input (analogue of exitWithError, but
    catchable). ``code`` is the reference taxonomy code
    (:class:`quest_tpu_torch.validation.ErrorCode`) when the failure came from the
    validation layer, else 0."""

    def __init__(self, message: str, func_name: str = "", code: int = 0):
        self.func_name = func_name
        self.code = code
        super().__init__(
            f"QuEST error in {func_name}: {message}" if func_name else message
        )


def _default_handler(message: str, func_name: str, code: int = 0) -> None:
    raise QuESTError(message, func_name, code)


_handler = _default_handler


def invalid_quest_input_error(message: str, func_name: str,
                              code: int = 0) -> None:
    """Dispatch an input-validation failure to the current handler.

    The reference exposes this as an overridable weak symbol
    (``QuEST_validation.c:134-137``) so embedders/tests can intercept
    validation failures; here tests can simply catch :class:`QuESTError`
    or install a custom hook via :func:`set_input_error_handler`. The
    reference requires the override not to return; if a custom handler does
    return, we still raise so invalid inputs can never reach the kernels.
    """
    if _handler is _default_handler:
        _default_handler(message, func_name, code)
    else:
        # custom handlers keep the reference's 2-arg weak-symbol signature
        _handler(message, func_name)
        raise QuESTError(message, func_name, code)


def set_input_error_handler(handler) -> None:
    """Replace the validation-failure handler (None restores the default)."""
    global _handler
    _handler = handler if handler is not None else _default_handler


# exact-name alias for the reference's overridable weak symbol
# (``invalidQuESTInputError``, ``QuEST.h:3191``) so a grep-level port of a
# reference embedder finds it under the name it knows
invalidQuESTInputError = invalid_quest_input_error
