from .pattern import (CodebooksPatternProvider, CoarseFirstPattern, DelayedPatternProvider,
                      LayoutCoord, MusicLMPattern, ParallelPatternProvider, Pattern,
                      UnrolledPatternProvider, get_pattern_provider)
