from .io import (load_video, load_video_with_timeout, preprocess,
                 save_video)
from .prefetch import PrefetchIterator, prefetched
from .dataset import (CogPairedCaptionDataset, PairedCaptionImageDataset,
                      PairedCaptionVideoDataset, shard_for_process)
from .degradation import degrade_video, sample_degradation_params
from .webds import TarVideoDataset
