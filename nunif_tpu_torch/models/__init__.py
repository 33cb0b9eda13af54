from .model import (Model, I2IBaseModel, model_kwargs, init_flax_default)
from .register import (register_model, register_model_factory, create_model,
                       get_model_names)
from .flax_params import from_flax, to_flax
from .io import save_model, load_model, read_checkpoint, NotPortedError

__all__ = [
    "Model", "I2IBaseModel", "model_kwargs", "init_flax_default",
    "register_model", "register_model_factory", "create_model", "get_model_names",
    "from_flax", "to_flax",
    "save_model", "load_model", "read_checkpoint", "NotPortedError",
]
