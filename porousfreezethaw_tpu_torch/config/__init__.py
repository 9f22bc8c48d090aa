from .expression import Expression, ExpressionError, Evaluator
from .evsubst import ev_subst
from .params import ParamFile, ParamError, parse_param_file
