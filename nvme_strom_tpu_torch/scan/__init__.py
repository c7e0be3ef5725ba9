from .heap import HEAP_MAGIC, PAGE_SIZE, HeapSchema, build_heap_file

__all__ = ["HEAP_MAGIC", "PAGE_SIZE", "HeapSchema", "build_heap_file"]
