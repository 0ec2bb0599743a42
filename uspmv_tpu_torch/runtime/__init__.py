from .operator import SpmvOperator
