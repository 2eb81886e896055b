"""syncs_per_epoch (count): the host's blocking CUDA runtime calls
(stream, device and event synchronisations, synchronous copies) in the
traced slice, an epoch: the trainer's chunk reads and the early-stopping
flag's read."""


def read(ctx):
    epochs = sum(ctx.job_epochs)
    if not epochs:
        return None
    return ctx.slice.blocking_calls() / epochs
