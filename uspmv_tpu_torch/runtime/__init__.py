"""The operator, its metrics and its instrumentation. ``SpmvOperator`` is
loaded at first use, so that the kernel wrappers under ``ops/`` can import
``runtime.profiling`` while ``runtime.operator`` imports them."""


def __getattr__(name):
    if name == "SpmvOperator":
        from .operator import SpmvOperator

        return SpmvOperator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
