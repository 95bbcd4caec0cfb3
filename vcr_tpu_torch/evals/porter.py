"""The Porter stemmer, as nltk's ``PorterStemmer()`` stems in its default
``NLTK_EXTENSIONS`` mode.

METEOR's stem stage needs it, and this package does not depend on nltk, so
this is a copy of ``nltk.stem.porter.PorterStemmer`` (nltk 3.10.0) reduced to
that one mode: the branches of the other two modes (the original paper's
algorithm and Martin Porter's extensions) are gone, and every branch of the
default mode is kept in its order.

    Porter, M. "An algorithm for suffix stripping."
    Program 14.3 (1980): 130-137.

From NLTK, the Natural Language Toolkit (https://www.nltk.org), Copyright
(C) 2001-2026 NLTK Project; licensed under the Apache License, Version 2.0
(http://www.apache.org/licenses/LICENSE-2.0).
"""

from __future__ import annotations

# Irregular forms: the errors drawn to Martin Porter's attention over 20
# years. word -> its stem.
_IRREGULAR_FORMS = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}

_VOWELS = frozenset("aeiou")


class PorterStemmer:
    """``stem(word)`` gives nltk's ``PorterStemmer().stem(word)``."""

    def __init__(self):
        self.pool = {form: key for key, forms in _IRREGULAR_FORMS.items()
                     for form in forms}

    @staticmethod
    def _is_consonant(word: str, i: int) -> bool:
        """A consonant is a letter other than a, e, i, o, u, and other than y
        preceded by a consonant; a run of y's alternates."""
        if word[i] in _VOWELS:
            return False
        if word[i] == "y":
            negate = False
            while i > 0 and word[i] == "y":
                negate = not negate
                i -= 1
            return (word[i] not in _VOWELS) != negate
        return True

    def _measure(self, stem: str) -> int:
        """m in [C](VC){m}[V]: the count of vowel-consonant boundaries."""
        cv = "".join("c" if self._is_consonant(stem, i) else "v"
                     for i in range(len(stem)))
        return cv.count("vc")

    def _has_positive_measure(self, stem: str) -> bool:
        return self._measure(stem) > 0

    def _contains_vowel(self, stem: str) -> bool:
        return any(not self._is_consonant(stem, i) for i in range(len(stem)))

    def _ends_double_consonant(self, word: str) -> bool:
        """*d: the word ends with a double consonant."""
        return (len(word) >= 2 and word[-1] == word[-2]
                and self._is_consonant(word, len(word) - 1))

    def _ends_cvc(self, word: str) -> bool:
        """*o: the stem ends cvc, the second c not w, x or y; or, an nltk
        extension, it is two letters, a vowel and a consonant."""
        return (
            len(word) >= 3
            and self._is_consonant(word, len(word) - 3)
            and not self._is_consonant(word, len(word) - 2)
            and self._is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")
        ) or (
            len(word) == 2
            and not self._is_consonant(word, 0)
            and self._is_consonant(word, 1)
        )

    @staticmethod
    def _replace_suffix(word: str, suffix: str, replacement: str) -> str:
        if suffix == "":
            return word + replacement
        return word[: -len(suffix)] + replacement

    def _apply_rule_list(self, word: str, rules) -> str:
        """Apply the first rule (suffix, replacement, condition or None) whose
        suffix the word has; if its condition fails, no later rule is
        tried. The suffix "*d" stands for a double consonant."""
        for suffix, replacement, condition in rules:
            if suffix == "*d" and self._ends_double_consonant(word):
                stem = word[:-2]
                if condition is None or condition(stem):
                    return stem + replacement
                return word
            if word.endswith(suffix):
                stem = self._replace_suffix(word, suffix, "")
                if condition is None or condition(stem):
                    return stem + replacement
                return word
        return word

    def _step1a(self, word: str) -> str:
        # nltk: 'flies' -> 'fli' but 'dies' -> 'die'
        if word.endswith("ies") and len(word) == 4:
            return self._replace_suffix(word, "ies", "ie")
        return self._apply_rule_list(word, [
            ("sses", "ss", None),
            ("ies", "i", None),
            ("ss", "ss", None),
            ("s", "", None),
        ])

    def _step1b(self, word: str) -> str:
        # nltk: 'spied' -> 'spi' but 'died' -> 'die'
        if word.endswith("ied"):
            if len(word) == 4:
                return self._replace_suffix(word, "ied", "ie")
            return self._replace_suffix(word, "ied", "i")
        if word.endswith("eed"):
            stem = self._replace_suffix(word, "eed", "")
            return stem + "ee" if self._measure(stem) > 0 else word
        for suffix in ("ed", "ing"):
            if word.endswith(suffix):
                intermediate_stem = self._replace_suffix(word, suffix, "")
                if self._contains_vowel(intermediate_stem):
                    break
        else:
            return word
        return self._apply_rule_list(intermediate_stem, [
            ("at", "ate", None),
            ("bl", "ble", None),
            ("iz", "ize", None),
            ("*d", intermediate_stem[-1],
             lambda stem: intermediate_stem[-1] not in ("l", "s", "z")),
            ("", "e", lambda stem: self._measure(stem) == 1 and self._ends_cvc(stem)),
        ])

    def _step1c(self, word: str) -> str:
        # nltk: y -> i only after a consonant that is not the whole stem
        return self._apply_rule_list(word, [
            ("y", "i", lambda stem: len(stem) > 1
             and self._is_consonant(stem, len(stem) - 1)),
        ])

    def _step2(self, word: str) -> str:
        # nltk: ALLI -> AL first, and the result through step 2 again
        if word.endswith("alli") and self._has_positive_measure(
                self._replace_suffix(word, "alli", "")):
            return self._step2(self._replace_suffix(word, "alli", "al"))
        pos = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("ational", "ate", pos),
            ("tional", "tion", pos),
            ("enci", "ence", pos),
            ("anci", "ance", pos),
            ("izer", "ize", pos),
            ("bli", "ble", pos),
            ("alli", "al", pos),
            ("entli", "ent", pos),
            ("eli", "e", pos),
            ("ousli", "ous", pos),
            ("ization", "ize", pos),
            ("ation", "ate", pos),
            ("ator", "ate", pos),
            ("alism", "al", pos),
            ("iveness", "ive", pos),
            ("fulness", "ful", pos),
            ("ousness", "ous", pos),
            ("aliti", "al", pos),
            ("iviti", "ive", pos),
            ("biliti", "ble", pos),
            ("fulli", "ful", pos),
            # the 'l' of 'logi' stays with the stem, so that short stems
            # like 'geo' and 'theo' work
            ("logi", "log", lambda stem: pos(word[:-3])),
        ])

    def _step3(self, word: str) -> str:
        pos = self._has_positive_measure
        return self._apply_rule_list(word, [
            ("icate", "ic", pos),
            ("ative", "", pos),
            ("alize", "al", pos),
            ("iciti", "ic", pos),
            ("ical", "ic", pos),
            ("ful", "", pos),
            ("ness", "", pos),
        ])

    def _step4(self, word: str) -> str:
        def gt1(stem):
            return self._measure(stem) > 1

        return self._apply_rule_list(word, [
            ("al", "", gt1),
            ("ance", "", gt1),
            ("ence", "", gt1),
            ("er", "", gt1),
            ("ic", "", gt1),
            ("able", "", gt1),
            ("ible", "", gt1),
            ("ant", "", gt1),
            ("ement", "", gt1),
            ("ment", "", gt1),
            ("ent", "", gt1),
            ("ion", "", lambda stem: self._measure(stem) > 1 and stem[-1] in ("s", "t")),
            ("ou", "", gt1),
            ("ism", "", gt1),
            ("ate", "", gt1),
            ("iti", "", gt1),
            ("ous", "", gt1),
            ("ive", "", gt1),
            ("ize", "", gt1),
        ])

    def _step5a(self, word: str) -> str:
        # both rules of the step are tried, so no _apply_rule_list
        if word.endswith("e"):
            stem = self._replace_suffix(word, "e", "")
            if self._measure(stem) > 1:
                return stem
            if self._measure(stem) == 1 and not self._ends_cvc(stem):
                return stem
        return word

    def _step5b(self, word: str) -> str:
        return self._apply_rule_list(
            word, [("ll", "l", lambda stem: self._measure(word[:-1]) > 1)])

    def stem(self, word: str) -> str:
        """The lowercase stem of ``word``."""
        stem = word.lower()
        if stem in self.pool:
            return self.pool[stem]
        if len(word) <= 2:
            # words of one or two letters are not stemmed
            return stem
        for step in (self._step1a, self._step1b, self._step1c, self._step2,
                     self._step3, self._step4, self._step5a, self._step5b):
            stem = step(stem)
        return stem
