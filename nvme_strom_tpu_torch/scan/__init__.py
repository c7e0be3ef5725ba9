from .heap import HEAP_MAGIC, PAGE_SIZE, HeapSchema, build_heap_file
from .strings import (StringDict, dict_path_for, encode_strings, load_dict,
                      save_dict)

__all__ = ["HEAP_MAGIC", "PAGE_SIZE", "HeapSchema", "StringDict",
           "build_heap_file", "create_table_as", "dict_path_for",
           "encode_strings", "load_dict", "parse_sql", "save_dict",
           "sql_query"]

_SQL = ("create_table_as", "parse_sql", "sql_query")


def __getattr__(name):
    # the SQL facade imports the kernels' modules, which import this
    # package's heap format: load it on first use, not at import
    if name in _SQL:
        from . import sql
        return getattr(sql, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
