from .video_sr import ModelBundle, STARPipeline
from .chunking import (chunked_x0_fn, make_chunks, sliding_windows_1d,
                       stitch_slices)
from .color_fix import adain_color_fix, wavelet_color_fix
from .cogvideo_sr import CogModelBundle, CogSamplerConfig, CogVideoSRPipeline
from .build import (CogModels, StarModels, build_cog_pipeline, build_pipeline,
                    init_random_cog_models, init_random_models, make_bundle)
