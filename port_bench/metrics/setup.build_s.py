"""setup.build_s: seconds of the benchmark's own host span around
train_gnn.build_train_state (BFS renumbering or the ELL relabelling, the
BSDA tables, uploads, the model and Adam). Moves setup_s."""


def read(ctx):
    return ctx.build_s
