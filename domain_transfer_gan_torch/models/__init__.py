from .api import GeneratorPair, build_generators, create_model
