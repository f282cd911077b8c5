from .probabilities import ProbabilityTable, get_error_param
