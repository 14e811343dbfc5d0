from .base import Compressor, create, register
from . import onebit  # registers "onebit"
from .decorators import VanillaErrorFeedback, NesterovMomentum
from .reducer import CompressionPlan
