"""Network building blocks and heads (counterpart of ``tpucv.nn``)."""
