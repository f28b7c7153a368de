from .io import (load_video, load_video_with_timeout, preprocess,
                 save_video)
from .prefetch import PrefetchIterator, prefetched
