"""The allocator's peak over set-up and window (torch.cuda.max_memory_allocated
after a reset at process start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
