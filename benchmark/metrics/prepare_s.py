"""prepare_s (s): the benchmark's span around ``train.prepare`` (LPA,
``build_graph``, the uploads, the kernel libraries' build or load), closed
by a device synchronisation."""


def read(ctx):
    return ctx.prepare_s
