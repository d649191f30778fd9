from dsl_tpu_torch.data.pipelines.compose import (  # noqa: F401
    Compose, test_pipeline_params)
from dsl_tpu_torch.data.pipelines import loading  # noqa: F401
from dsl_tpu_torch.data.pipelines import transforms  # noqa: F401
from dsl_tpu_torch.data.pipelines import strong_aug  # noqa: F401
from dsl_tpu_torch.data.pipelines import extra_transforms  # noqa: F401
from dsl_tpu_torch.data.pipelines import geometric  # noqa: F401
