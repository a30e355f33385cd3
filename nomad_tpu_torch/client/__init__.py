"""The port's client side: so far the node fingerprints (copies of
``nomad_tpu/client/``) and the configuration they read."""

from .config import ClientConfig  # noqa: F401
from .fingerprint import BUILTIN_FINGERPRINTS, fingerprint_node  # noqa: F401
