"""Training utilities of the port: so far only ``checkpoint`` (the JAX
package's path-keyed ``.npz`` format).  The optimizers and train steps
(``repro/training/optim.py``, ``steps.py``) are not ported yet."""
from . import checkpoint

__all__ = ["checkpoint"]
