from .mesh import (DeviceGrid, device_listing, local_devices, make_mesh,
                   sharded_kmer_histogram)

__all__ = ["DeviceGrid", "device_listing", "local_devices", "make_mesh",
           "sharded_kmer_histogram"]
