"""Sharded indexes over a mesh of devices, merged with torch.distributed
collectives (the port's counterpart of ``ngt_tpu/parallel``)."""
