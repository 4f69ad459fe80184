from .serializer import dump, load, load_metadata, load_model_json  # noqa: F401
