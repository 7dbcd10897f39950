"""The learned models: DispNet-lite (stereo disparity) and SegNet-lite
(car masks), ``nn.Module`` counterparts of ``dynslam_tpu/models/``."""
