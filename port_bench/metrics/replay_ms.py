"""replay_ms: the device time of one replayed epoch, the mean over the
window's blocks of the trainer's own loop_info["replay_ms"] (CUDA events
around each block's replays), the traced blocks left out. Moves epoch_ms."""


def read(ctx):
    if not ctx.replay_ms:
        return None
    return sum(ctx.replay_ms) / len(ctx.replay_ms)
