from .cache import BriefingCache
from .engine import (Briefing, BriefingConfig, BriefingEngine,
                     BriefingSection, GraphVersion, kind_to_section_title,
                     pluralise)
from .renderer import CompactRenderer, MarkdownRenderer

__all__ = [
    "Briefing", "BriefingCache", "BriefingConfig", "BriefingEngine",
    "BriefingSection", "GraphVersion", "kind_to_section_title", "pluralise",
    "CompactRenderer", "MarkdownRenderer",
]
