"""The consul-shaped service catalog and service client (a copy of
``nomad_tpu/consul/``)."""

from .catalog import CatalogEntry, ServiceCatalog
from .service_client import ServiceClient

__all__ = ["CatalogEntry", "ServiceCatalog", "ServiceClient"]
