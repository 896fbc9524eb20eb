"""Debug assertion layer — the ``PLSSVM_ASSERT`` analog.

TPU-native equivalent of ``include/plssvm/detail/assert.hpp:36-65``: a
formatted, source-located assertion that is compiled out of hot paths
unless explicitly enabled.  The reference activates its asserts in Debug
builds or with ``PLSSVM_ENABLE_ASSERTS``; here the switch is the
``PLSSVM_ENABLE_ASSERTS`` environment variable (read once at import, like
the reference's compile-time macro), so the production path pays a single
cheap boolean check per call site.

Assertions guard *internal invariants* (shape agreement, packing
consistency) on the host side only — values inside ``jit``-traced code are
abstract and cannot be asserted here; those invariants are covered by the
oracle-comparison tests instead (SURVEY.md §4).
"""

from __future__ import annotations

import os

from ..exceptions import SourceLocation

#: read once at import — the analog of the reference's compile-time
#: PLSSVM_ASSERT_ENABLED macro (assert.hpp:61-65)
ASSERTS_ENABLED: bool = os.environ.get("PLSSVM_ENABLE_ASSERTS", "0") not in (
    "0", "", "off", "false")


class PLSSVMAssertionError(AssertionError):
    """Raised by :func:`plssvm_assert`; carries the capture location.

    The reference aborts the process (``assert.hpp:56``); an exception is
    the Python-idiomatic equivalent and keeps the failure testable.
    """

    def __init__(self, msg: str, loc: SourceLocation) -> None:
        super().__init__(
            f"Assertion '{msg}' failed!\n"
            f"  in file      {loc.file_name}\n"
            f"  in function  {loc.function_name}\n"
            f"  @ line       {loc.line}"
        )
        self.loc = loc


def plssvm_assert(condition: bool, msg: str, *args, **kwargs) -> None:
    """Assert an internal invariant (``PLSSVM_ASSERT``, ``assert.hpp:36-53``).

    ``msg`` is ``str.format``-style, formatted lazily — only on failure —
    so call sites stay cheap when asserts are enabled and free when not.
    ``args``/``kwargs`` ARE evaluated at the call site like any Python
    arguments: pass only cheap values (shapes, scalars); guard expensive
    diagnostics with an explicit ``if ASSERTS_ENABLED:`` block.
    """
    if not ASSERTS_ENABLED or condition:
        return
    if args or kwargs:
        msg = msg.format(*args, **kwargs)
    raise PLSSVMAssertionError(msg, SourceLocation.current(depth=2))
