from .base import Compressor, create, register, registered_names
from . import dithering, onebit, randomk, topk  # register the compressors
from .decorators import VanillaErrorFeedback, NesterovMomentum
from .reducer import CompressionPlan
