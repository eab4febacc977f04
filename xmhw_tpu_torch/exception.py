"""Framework exception type.

Mirrors the single validation-error type of the reference implementation
(reference: xmhw/exception.py:18-19) so user code catching ``XmhwException``
ports over unchanged.
"""


class XmhwException(Exception):
    """Raised for all user-input validation errors in xmhw_tpu."""

    pass
