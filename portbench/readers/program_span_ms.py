"""Mean host milliseconds of one of the port's own spans (``args.span``, a
``utils/profiling.span`` of the port), from the port's recorder. The recorder
records only while a profiler runs, and the harness's profiler covers the
window alone, so in a traced run it holds the window's calls. None where the
port has no recorder or the span did not run."""


def read(metric, rec):
    try:
        from anime_illust_image_searcher_tpu_torch.utils import profiling

        got = profiling.recorded().get(metric["args"]["span"])
    except (ImportError, AttributeError):
        return None
    return 1e3 * got["total_s"] / got["count"] if got and got["count"] else None
