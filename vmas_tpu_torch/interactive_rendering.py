"""Module-path alias of :mod:`vmas_tpu_torch.render.interactive` (the class,
the ``render_interactively`` entry point and the command line), as
vmas_tpu/interactive_rendering.py is of the JAX package's:
``python -m vmas_tpu_torch.interactive_rendering --scenario waterfall``."""

from vmas_tpu_torch.render.interactive import (  # noqa: F401
    InteractiveEnv,
    main,
    parse_args,
    render_interactively,
)

if __name__ == "__main__":
    main()
