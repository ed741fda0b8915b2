from mymedialite_tpu_torch.io.model_io import (  # noqa: F401
    ModelReader, ModelWriter, peek_model_name,
)
