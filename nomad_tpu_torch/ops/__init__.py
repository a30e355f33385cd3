"""Device path of the port: encode, transfer packing, kernels, decode and
the batch scheduler.  Importing this package imports no device code;
kernels are built on first use (see ``nomad_tpu_torch.device``)."""
