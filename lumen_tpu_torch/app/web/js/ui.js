// Small DOM helpers shared by the views (no framework, no build step).

export function el(tag, attrs = {}, children = []) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    // undefined/null/false mean "attribute absent" — setAttribute would
    // stringify them, and boolean attributes like disabled activate on
    // ANY value.
    if (v === undefined || v === null || v === false) continue;
    if (k === "class") node.className = v;
    else if (k.startsWith("on") && typeof v === "function") node[k] = v;
    else node.setAttribute(k, v);
  }
  if (!Array.isArray(children)) children = [children];
  for (const child of children) {
    if (child === null || child === undefined || child === "") continue;
    node.append(child instanceof Node ? child : document.createTextNode(String(child)));
  }
  return node;
}

import { describeUiError } from "./errors.js";

/** Uniform failure surface: classify the error (network/permission/
 * business/server) and toast "<title>: <message>". */
export function toastError(error, fallback) {
  const d = describeUiError(error, fallback);
  toast(`${d.title}: ${d.message}`, true);
}

let toastTimer = null;

export function toast(message, isError = false) {
  document.querySelectorAll(".toast").forEach((t) => t.remove());
  const node = el("div", { class: `toast${isError ? " err" : ""}` }, message);
  document.body.append(node);
  clearTimeout(toastTimer);
  toastTimer = setTimeout(() => node.remove(), isError ? 6000 : 3000);
}

export function logLine(frame) {
  const t = new Date((frame.ts || Date.now() / 1000) * 1000);
  const hh = t.toTimeString().slice(0, 8);
  const line = el("p", { class: "logline" }, [el("time", {}, hh), frame.message || ""]);
  if (/error|failed|traceback/i.test(frame.message || "")) line.classList.add("err");
  return line;
}

export function attachLogPane(pane, logStream, maxLines = 500) {
  const unsub = logStream.subscribe((frame) => {
    pane.append(logLine(frame));
    while (pane.childElementCount > maxLines) pane.firstElementChild.remove();
    pane.scrollTop = pane.scrollHeight;
  });
  return unsub;
}
