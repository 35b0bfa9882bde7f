"""The first pass's false starts: candidate block starts that failed trial
decompression over those tried, summed over the window's readers
(``FetcherStats``)."""


def read(run):
    f = run.data["fetcher"]
    tried = f.get("candidates_tried", 0)
    return 100.0 * f.get("false_positive_starts", 0) / tried if tried else None
