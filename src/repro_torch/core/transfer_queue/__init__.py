from repro_torch.core.transfer_queue.control_plane import (BatchMeta,
                                                           TransferQueueController)
from repro_torch.core.transfer_queue.data_plane import DataPlane, StorageUnit
from repro_torch.core.transfer_queue.queue import StreamingDataLoader, TransferQueue

__all__ = ["TransferQueue", "StreamingDataLoader", "TransferQueueController",
           "BatchMeta", "DataPlane", "StorageUnit"]
