"""`syncs_per_batch`: synchronising CUDA calls in one warm call of the program, counted
under `torch.cuda.set_sync_debug_mode("warn")`."""


def read(ctx):
    return ctx.syncs
