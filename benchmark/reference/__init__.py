"""The plain float32 references the benchmark judges the port by.

Each configuration names its reference model by module and class
(``configs/<name>.json``, key ``reference``); ``build`` makes it. Nothing
under this package imports the port (``margipose_tpu_torch``) or the JAX
package, and nothing here takes anything the port made.
"""

import importlib


def build(spec):
    """The reference model ``spec`` names: ``{"module", "class", "kwargs"}``,
    the module under ``benchmark.reference``."""
    module = importlib.import_module(f"benchmark.reference.{spec['module']}")
    return getattr(module, spec['class'])(**spec.get('kwargs', {}))
