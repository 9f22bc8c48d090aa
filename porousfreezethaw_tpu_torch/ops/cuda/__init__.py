from .stencil import (DeltaAttempt, fused_stage, delta_g, make_delta_g,
                      make_fused_stage)
