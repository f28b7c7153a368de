from .unet import ControlledV2VUNet, VideoUNetTrunk
