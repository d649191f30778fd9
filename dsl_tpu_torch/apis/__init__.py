from dsl_tpu_torch.apis.inference import (  # noqa: F401
    DetectorBundle, inference_detector, init_detector)
from dsl_tpu_torch.apis.train import train_detector  # noqa: F401
from dsl_tpu_torch.apis.test import single_device_test  # noqa: F401
