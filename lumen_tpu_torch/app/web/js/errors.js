// Error presentation (role of the reference's
// web-ui/src/lib/errorPresentation.ts): classify an API failure into a
// kind + title so every view surfaces failures the same way instead of
// raw fetch messages.

export class ApiError extends Error {
  /** @param {string} message @param {number|null} status @param {object|null} data parsed error body (e.g. /config/validate field_errors) */
  constructor(message, status = null, data = null) {
    super(message);
    this.status = status;
    this.data = data;
    this.kind =
      status === null ? "network"
      : status === 401 || status === 403 ? "permission"
      : status >= 500 ? "server"
      : status >= 400 ? "business"
      : "unknown";
  }
}

const TITLES = {
  network: "Control plane unreachable",
  permission: "Permission denied",
  business: "Request rejected",
  server: "Control plane error",
  unknown: "Request failed",
};

/** @returns {{title: string, message: string, kind: string}} */
export function describeUiError(error, fallbackMessage = "something went wrong") {
  if (error instanceof ApiError) {
    return {
      title: TITLES[error.kind] || TITLES.unknown,
      message: error.message || fallbackMessage,
      kind: error.kind,
    };
  }
  if (error instanceof Error) {
    return { title: TITLES.unknown, message: error.message || fallbackMessage, kind: "unknown" };
  }
  return { title: "Unknown error", message: fallbackMessage, kind: "unknown" };
}
