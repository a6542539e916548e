"""JAX references of the port's CPU tests, compiled once instead of
dispatched op by op. Eager JAX compiles every op it meets for its shapes
(a GAT value and gradient: hundreds of compiles, some 20 s on the CPU);
`jit_as_eager(fn)` compiles fn whole with the XLA passes that merge or
rewrite ops across op boundaries turned off (fusion, algsimp), so that each
op rounds as it does alone. On the references compiled so the outputs are
eager JAX's bit for bit (the GAT attention's value and gradients, the ELL
attention, the GSPMD GAT vjp, most eval logits), or differ from them by an
ulp of some entries: at most 2.4e-7 in values of order one and 9.5e-7 in
a logit of order ten, a tenth at most of the tolerance each is held to. Plain jax.jit also fuses reductions across ops
and moves the references further (the GAT attention's gradient closer to
its rtol-1e-5 bound)."""
import jax

NO_CROSS_OP = {"xla_disable_hlo_passes": "fusion,cpu-instruction-fusion,algsimp"}


def jit_as_eager(fn):
    """fn(*args) compiled for the arguments' shapes with NO_CROSS_OP."""
    def run(*args):
        return jax.jit(fn).lower(*args).compile(compiler_options=NO_CROSS_OP)(*args)

    return run
