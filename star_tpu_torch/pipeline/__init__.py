from .video_sr import ModelBundle, STARPipeline
from .chunking import (chunked_x0_fn, make_chunks, sliding_windows_1d,
                       stitch_slices)
from .color_fix import adain_color_fix, wavelet_color_fix
from .build import StarModels, build_pipeline, init_random_models, make_bundle
