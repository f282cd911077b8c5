from .variant import VariantBubble
from .graph import ChromosomeGraph
from .builder import PanelBuilder
from .sampling import PathSampler
from .variant import GenotypeLikelihoods, SampledPanel, VariantStats
