"""Layer: the engine's host path (the chunk packer, ``pack.py`` and
``csrc/pack.cc``). Documents a call read from non-ASCII ``str`` storage and
transcoded to UTF-8, as the engine's ``wide_docs`` counts them (the rest
are copied as they are); None where the program keeps no such counter."""


def read(ctx):
    if "wide_docs" not in ctx.before or "wide_docs" not in ctx.after:
        return None
    return ctx.delta("wide_docs") / ctx.calls
