from .harness import (EvalResult, OverlapEvalResult,  # noqa: F401
                      evaluate_overlap_slice, evaluate_slice,
                      inference_generator, polarity_rescue)
