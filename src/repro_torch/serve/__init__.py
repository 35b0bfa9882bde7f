from .serve_step import make_serve_steps, prefill_to_decode_caches

__all__ = ["make_serve_steps", "prefill_to_decode_caches"]
