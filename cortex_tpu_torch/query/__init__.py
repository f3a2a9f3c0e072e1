from .dsl import (CompileError, FieldFilter, FilterExpr, ParseError,
                  compile_expr, parse, parse_and_compile)

__all__ = ["CompileError", "FieldFilter", "FilterExpr", "ParseError",
           "compile_expr", "parse", "parse_and_compile"]
