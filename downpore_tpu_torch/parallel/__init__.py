from .mesh import (DeviceGrid, device_listing, local_devices, make_mesh,
                   sharded_chain, sharded_hit_counts, sharded_kmer_histogram,
                   sharded_pipeline_step)

__all__ = ["DeviceGrid", "device_listing", "local_devices", "make_mesh",
           "sharded_chain", "sharded_hit_counts", "sharded_kmer_histogram",
           "sharded_pipeline_step"]
